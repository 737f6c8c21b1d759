"""The port's archive runner (``parallel.archive.reprocess_corpus``), on the CPU.

On the 3 x 40 s corpus of tests/test_archive.py: the port's
``reprocess_corpus(batch_size=2, device="cpu")`` writes the same default
report bytes as the JAX package's and the same manifest but for
``finished_at``, ``stage_times``, ``output`` (each its own directory) and the
wire name; a corrupt file is quarantined while the rest decode; ``resume``
skips what is done and ``resume=False`` decodes again; the port's CLI
``--corpus``; the WAV header and conditioned reads with and without the C
library give the same reports; files of two sample rates never share a
batch.  Marked slow (JAX compiles a 4-row float batch program): a
mixed-encoding batch against the JAX runner's reports.
"""

import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from axctdprocessor_tpu_torch.models import simulator
from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
from axctdprocessor_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(2)

STAGES = {"io.read_wavs", "device.dispatch_batch", "device.fetch_batch", "io.write_reports"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i in range(3):
        spec = simulator.SimSpec(duration=40.0, profile_start=33.0, seed=50 + i)
        pcm, _ = simulator.synthesize(spec)
        p = str(d / f"drop{i}.wav")
        simulator.write_wav(p, pcm, spec.fs)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def ours(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out_torch"))
    timer = StageTimer()
    return out, reprocess_corpus(corpus, out, batch_size=2, device="cpu", timer=timer), timer


def _reports(out_dir, names=("drop0", "drop1", "drop2")):
    return {n: open(os.path.join(out_dir, n + ".txt"), "rb").read() for n in names}


def test_corpus_reports_and_manifest(ours, corpus):
    out, manifest, timer = ours
    assert set(manifest["files"]) == {os.path.basename(p) for p in corpus}
    for name, entry in manifest["files"].items():
        assert entry["status"] == "done" and entry["decode_status"] == 2, name
        assert entry["wire"] == "int16" and entry["rows"] > 100
        assert "overflow" not in entry
    for text in _reports(out).values():
        assert b"Probe Serial: 00123456" in text and text.count(b"\n") > 100
    assert set(manifest["stage_times"]) == STAGES
    assert timer.counts["device.dispatch_batch"] == 2  # batches of 2 and 1
    assert json.load(open(os.path.join(out, "manifest.json"))) == manifest
    assert not os.path.exists(os.path.join(out, "manifest.json.tmp"))


def test_corpus_reports_equal_jax(ours, corpus, tmp_path):
    """Default report bytes equal; the manifests equal but for the clock,
    the stage times, the output paths and the wire name."""
    from axctdprocessor_tpu.parallel.archive import reprocess_corpus as jreprocess

    out, manifest, _ = ours
    jout = str(tmp_path / "out_jax")
    jmanifest = jreprocess(corpus, jout, batch_size=2)
    assert _reports(out) == _reports(jout)
    drop = ("finished_at", "output", "wire")
    strip = lambda m: {k: {f: v for f, v in e.items() if f not in drop}  # noqa: E731
                       for k, e in m["files"].items()}
    assert strip(manifest) == strip(jmanifest)
    assert set(manifest["stage_times"]) == set(jmanifest["stage_times"])


def test_corrupt_file_quarantined(corpus, ours, tmp_path):
    bad = str(tmp_path / "corrupt.wav")
    open(bad, "wb").write(b"RIFFgarbage_that_is_not_a_wav")
    out = str(tmp_path / "out3")
    manifest = reprocess_corpus([corpus[0], bad], out, batch_size=2, device="cpu")
    assert manifest["files"]["drop0.wav"]["status"] == "done"
    failed = manifest["files"]["corrupt.wav"]
    assert failed["status"] == "failed" and "error" in failed
    assert _reports(out, ["drop0"])["drop0"] == _reports(ours[0], ["drop0"])["drop0"]
    assert not os.path.exists(os.path.join(out, "corrupt.txt"))
    # a batch with nothing readable leaves only the manifest
    out_b = str(tmp_path / "out3b")
    manifest = reprocess_corpus([bad], out_b, batch_size=2, device="cpu")
    assert manifest["files"]["corrupt.wav"]["status"] == "failed"
    assert os.listdir(out_b) == ["manifest.json"]


def test_resume_skips_done_and_no_resume_decodes_again(corpus, tmp_path):
    out = str(tmp_path / "out2")
    m1 = reprocess_corpus(corpus[:1], out, batch_size=2, device="cpu")
    t1 = m1["files"]["drop0.wav"]["finished_at"]
    timer = StageTimer()
    m2 = reprocess_corpus(corpus[:2], out, batch_size=2, device="cpu", resume=True, timer=timer)
    assert len(m2["files"]) == 2
    assert m2["files"]["drop0.wav"]["finished_at"] == t1, "decoded a done file again"
    assert timer.counts["device.dispatch_batch"] == 1
    timer = StageTimer()
    m3 = reprocess_corpus(corpus[:2], out, batch_size=2, device="cpu", resume=True, timer=timer)
    assert timer.counts.get("device.dispatch_batch", 0) == 0  # nothing left to decode
    assert {k: v["finished_at"] for k, v in m3["files"].items()} == \
        {k: v["finished_at"] for k, v in m2["files"].items()}
    m4 = reprocess_corpus(corpus[:1], out, batch_size=2, device="cpu", resume=False)
    assert list(m4["files"]) == ["drop0.wav"]
    assert m4["files"]["drop0.wav"]["finished_at"] > t1


def test_cli_corpus_mode(corpus, ours, tmp_path, capsys):
    from axctdprocessor_tpu_torch import cli

    out = str(tmp_path / "cli_out")
    argv = ["--corpus", os.path.dirname(corpus[0]), "-o", out, "--batch-size", "2",
            "--device", "cpu"]
    assert cli.main(argv + ["--quiet"]) == 0
    assert sorted(os.listdir(out)) == ["drop0.txt", "drop1.txt", "drop2.txt", "manifest.json"]
    # the CLI passes -d as a float, which the settings echo prints as it is
    as_api = {n: t.replace(b"Dead frequency: 3000.0\n", b"Dead frequency: 3000\n")
              for n, t in _reports(out).items()}
    assert as_api == _reports(ours[0])
    assert capsys.readouterr().out == ""
    assert cli.main(argv + ["--no-resume", "--wire", "int8", "--diagnostics"]) == 0
    assert "3/3 drops decoded" in capsys.readouterr().out
    manifest = json.load(open(os.path.join(out, "manifest.json")))
    assert {e["wire"] for e in manifest["files"].values()} == {"int8"}
    text = open(os.path.join(out, "drop0.txt")).read()
    assert "Wire format: int8" in text and ", R400, dR7500" in text
    assert cli.main(["--corpus", str(tmp_path / "nothing_here"), "-o", out]) == 1


def test_corpus_needs_the_device_it_is_asked_for(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = str(tmp_path / "never")
    with pytest.raises(RuntimeError, match="cuda"):
        reprocess_corpus(corpus, out, batch_size=2)
    assert not os.path.exists(out)  # raised before any work


def _copy_as(src, dst, kind):
    """A stereo int16 copy (channel 0 is read raw) or a float32 copy (the
    host conditioning path) of an int16 mono WAV."""
    fs, snd = wavfile.read(src)
    wavfile.write(dst, fs, np.stack([snd, snd], axis=1) if kind == "stereo"
                  else (snd / 32768.0).astype(np.float32))


def test_same_reports_with_and_without_the_c_library(corpus, ours, tmp_path, monkeypatch):
    """``wav_info`` and ``read_wav_conditioned_f32`` return None without the
    C library; the scipy path then forms the same batches (a float32 WAV
    takes the float path and the int16 row beside it is conditioned on the
    host to match)."""
    f32 = str(tmp_path / "f32.wav")
    _copy_as(corpus[0], f32, "float32")
    paths = [corpus[1], f32]
    out_c, out_np = str(tmp_path / "with_c"), str(tmp_path / "numpy")
    m_c = reprocess_corpus(paths, out_c, batch_size=2, device="cpu")
    monkeypatch.setenv("AXCTD_NO_NATIVE", "1")
    m_np = reprocess_corpus(paths, out_np, batch_size=2, device="cpu")
    for m in (m_c, m_np):
        assert {e["status"] for e in m["files"].values()} == {"done"}
        assert {e["wire"] for e in m["files"].values()} == {"float32"}
    names = ["drop1", "f32"]
    np_reports = _reports(out_np, names)
    assert b"Probe Serial: 00123456" in np_reports["f32"]
    assert _reports(out_c, names) == np_reports
    assert np_reports["drop1"] == _reports(ours[0], names[:1])["drop1"]


def test_mixed_sample_rates(corpus, tmp_path):
    """Files with different fs never share a decode batch."""
    spec = simulator.SimSpec(fs=22050, duration=40.0, profile_start=33.0, seed=60)
    pcm, _ = simulator.synthesize(spec)
    p22 = str(tmp_path / "drop22k.wav")
    simulator.write_wav(p22, pcm, spec.fs)
    out = str(tmp_path / "out_mixed")
    timer = StageTimer()
    manifest = reprocess_corpus([corpus[0], p22, corpus[1]], out, batch_size=3,
                                device="cpu", timer=timer)
    assert all(v["status"] == "done" for v in manifest["files"].values())
    assert timer.counts["device.dispatch_batch"] == 2
    for name in ("drop0.txt", "drop22k.txt"):
        assert "Probe Serial: 00123456" in open(os.path.join(out, name)).read(), name
    assert "Sampling frequency (fs): 22050 Hz" in open(os.path.join(out, "drop22k.txt")).read()


@pytest.mark.slow  # a 4-row float batch against the JAX runner's
def test_mixed_encoding_batch_not_demoted(corpus, tmp_path):
    """A stereo file, a float32 (float-path) file and a corrupt file in one
    batch: per-file fallback only, and the JAX runner's report bytes."""
    from axctdprocessor_tpu.parallel.archive import reprocess_corpus as jreprocess

    stereo, f32 = str(tmp_path / "stereo.wav"), str(tmp_path / "f32.wav")
    _copy_as(corpus[0], stereo, "stereo")
    _copy_as(corpus[2], f32, "float32")
    bad = str(tmp_path / "corrupt2.wav")
    open(bad, "wb").write(b"RIFFnot_really_a_wav_file")
    paths = [stereo, f32, bad, corpus[1]]
    out, jout = str(tmp_path / "out_mixed_enc"), str(tmp_path / "jax_mixed_enc")
    manifest = reprocess_corpus(paths, out, batch_size=4, device="cpu")
    jreprocess(paths, jout, batch_size=4)
    assert manifest["files"]["corrupt2.wav"]["status"] == "failed"
    names = ["stereo", "f32", "drop1"]
    assert {manifest["files"][n + ".wav"]["wire"] for n in names} == {"float32"}
    for text in _reports(out, names).values():
        assert b"Probe Serial: 00123456" in text
    assert _reports(out, names) == _reports(jout, names)
