"""The port's archive tools on the CPU: the mixed-rate corpus and the demos.

* JAX's ``reprocess_corpus`` and the port's (``device="cpu"``) over one small
  corpus of the kinds ``scripts/corpus_1000.py`` builds: two 44.1 kHz drops
  of different lengths, a short 88.2 kHz drop and the five corrupt files:
  the same statuses, the same quarantine set, byte-equal reports; the port's
  drops held to their truth as ``tools/corpus_1000.py`` holds them.  Both
  runners read a WAV above 50 kHz through the host reader, which decimates
  it by 2 (``utils/wavio.read_wav``): the 88.2 kHz drop decodes as a float
  row at 44.1 kHz, in a batch of its own.
* ``tools/corpus_1000.build_corpus`` writes, at a small ``CORPUS_N``, the WAVs
  of the JAX script's ``build_corpus`` byte for byte.
* ``tools/decode_demo.py --device cpu`` runs.
"""

import filecmp
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from axctdprocessor_tpu_torch.models import simulator
from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
from axctdprocessor_tpu_torch.tools import corpus_1000

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drop(path, fs, duration, seed):
    spec = simulator.SimSpec(fs=fs, duration=duration, profile_start=33.0, seed=seed)
    pcm, truth = simulator.synthesize(spec)
    simulator.write_wav(path, pcm, fs)
    return truth, pcm


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    made = {"a44.wav": _drop(str(d / "a44.wav"), 44100, 40.0, 61),
            "b44.wav": _drop(str(d / "b44.wav"), 44100, 52.0, 62),
            "c88.wav": _drop(str(d / "c88.wav"), 88200, 38.0, 63)}
    truths = {name: truth for name, (truth, _) in made.items()}
    pcm = made["a44.wav"][1]
    base = np.round(pcm * (28000 / np.max(np.abs(pcm)))).astype(np.int16)
    corpus_1000.write_corrupt_files(str(d), np.random.default_rng(3), base)
    paths = sorted(str(p) for p in d.iterdir())
    out = str(tmp_path_factory.mktemp("mixed_out"))
    return paths, truths, out, reprocess_corpus(paths, out, batch_size=8, device="cpu")


def test_mixed_corpus_quarantine_and_truth(mixed):
    paths, truths, out, manifest = mixed
    status = {n: e["status"] for n, e in manifest["files"].items()}
    assert status == {**{n: "done" for n in truths}, **{n: "failed" for n in corpus_1000.CORRUPT}}
    assert manifest["files"]["c88.wav"]["rows"] > 50
    assert manifest["files"]["c88.wav"]["wire"] == "float32"  # decimated on the host
    assert "Sampling frequency (fs): 44100.0 Hz" in open(os.path.join(out, "c88.txt")).read()
    held = corpus_1000.check_against_truth(manifest, truths)
    assert held["held_to_truth"] == 3 and held["lowest_in_truth"] > corpus_1000.IN_TRUTH
    assert sorted(os.listdir(out)) == ["a44.txt", "b44.txt", "c88.txt", "manifest.json"]


def test_mixed_corpus_equals_jax_runner(mixed, tmp_path):
    """The same statuses and quarantine set as the JAX runner, and the same
    report bytes (the 88.2 kHz drop decimated on the host by both)."""
    from axctdprocessor_tpu.parallel.archive import reprocess_corpus as jreprocess

    paths, truths, out, manifest = mixed
    jout = str(tmp_path / "jax_out")
    jmanifest = jreprocess(paths, jout, batch_size=8)
    assert {n: e["status"] for n, e in jmanifest["files"].items()} == \
        {n: e["status"] for n, e in manifest["files"].items()}
    for name in truths:
        txt = os.path.splitext(name)[0] + ".txt"
        assert filecmp.cmp(os.path.join(out, txt), os.path.join(jout, txt), shallow=False), name
        for key in ("rows", "decode_status"):
            assert manifest["files"][name][key] == jmanifest["files"][name][key], (name, key)


def _jax_script(monkeypatch, corpus_dir):
    """``scripts/corpus_1000.py`` as a module, its corpus directory pointed
    at `corpus_dir`; its artifact helper (which sets jax's compilation cache)
    is not loaded, and the environment it sets is restored after the test."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(corpus_dir) + "_cache")
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "10")
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script prepends its directory
    artifact = types.ModuleType("_artifact")
    artifact.record = None
    monkeypatch.setitem(sys.modules, "_artifact", artifact)
    spec = importlib.util.spec_from_file_location(
        "_corpus_1000_jax", os.path.join(REPO, "scripts", "corpus_1000.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CORPUS_DIR = str(corpus_dir)
    return mod


N_SMALL = 16  # a small CORPUS_N: 11 drops and the 5 corrupt files


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    ours = tmp_path_factory.mktemp("small")
    corpus_1000.build_corpus(str(ours), N_SMALL)
    return ours


def test_build_corpus_writes_the_jax_scripts_corpus(small, tmp_path, monkeypatch):
    jax_dir, ours, n_files = tmp_path / "jax", small, N_SMALL
    monkeypatch.setenv("CORPUS_N", str(n_files))
    script = _jax_script(monkeypatch, jax_dir)
    assert script.N_FILES == n_files and script.SPECS == corpus_1000.SPECS
    script.build_corpus()
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(ours)) and len(names) == n_files
    assert set(corpus_1000.CORRUPT) <= set(names)
    match, mismatch, errors = filecmp.cmpfiles(jax_dir, ours, names, shallow=False)
    assert not mismatch and not errors and len(match) == n_files
    seconds = corpus_1000.drop_seconds(sorted(str(ours / n) for n in names))
    assert len(seconds) == n_files - corpus_1000.N_CORRUPT
    assert set(round(s) for s in seconds.values()) <= {45, 60, 90, 120}


def test_corpus_tool_run_and_resume_on_the_cpu(small, tmp_path):
    """``tools/corpus_1000.run`` on the small corpus: its accounting and truth
    gates hold, its record has the JAX script's fields; run again, it resumes
    and decodes nothing."""
    out = str(tmp_path / "out")
    rec = corpus_1000.run(N_SMALL, str(small), out, device="cpu")
    assert rec["done"] == rec["held_to_truth"] == N_SMALL - corpus_1000.N_CORRUPT
    assert rec["accounted"] == N_SMALL and rec["reports_written"] == rec["done"]
    assert sorted(rec["quarantine_entries"]) == sorted(corpus_1000.CORRUPT)
    assert rec["audio_s_decoded_this_run"] == rec["audio_s_total"] > 0
    again = corpus_1000.run(N_SMALL, str(small), out, device="cpu")
    assert again["resumed_from"] == again["done"] and again["decoded_this_run"] == 0
    paths = sorted(str(small / n) for n in os.listdir(small))
    truths = corpus_1000.truths_of(paths, corpus_1000.drop_seconds(paths),
                                   corpus_1000.synthesize_bases())
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    wrong = {n: dict(t, serial_no="00000000") for n, t in truths.items()}
    with pytest.raises(AssertionError):  # a report that misses its truth fails the gate
        corpus_1000.check_against_truth(manifest, wrong)


def test_decode_demo_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "axctdprocessor_tpu_torch/tools/decode_demo.py",
                           "--device", "cpu", "--dir", str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.splitlines()
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == \
        ["parity engine", "device engine", "host stream", "device stream"], lines
    assert "serial 00123456" in lines[0] and os.path.exists(tmp_path / "demo_drop.wav")
    assert lines[-2].endswith("status 2") and lines[-1].endswith("status 2"), lines
    assert "jax" not in done.stderr
