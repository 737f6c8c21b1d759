"""The port stands alone: the machine with the GPU has no jax, and the port
imports nothing of the JAX package.

A fresh interpreter imports ``axctdprocessor_tpu_torch`` and decodes a
short drop on the CPU through each path (monolithic, segmented, prestaged,
stream and batch, the int4 wire through the port's C encoder, the host parity
engine and its push decoder, a two-batch pipeline and a two-file corpus, a
time-sharded decode on a 1 x 2 mesh and a batch over a ``dp`` mesh of the CPU,
and the multi-host runner with one process), and
resolves every lazy top-level name; importing the package alone loads no
torch, and the CLI's ``--engine parity`` decodes a WAV without ever loading
it (nor does any module of the host parity path); neither jax
nor any module of ``axctdprocessor_tpu`` may enter ``sys.modules``.  A scan
of every ``.py`` of the port and of ``chip_smoke.py`` finds no import of
the JAX package, the port's native library builds only under its own
``_build/``, and the port's simulator copy synthesizes the JAX package's
drops exactly.
"""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from axctdprocessor_tpu.models import simulator as jsim
from axctdprocessor_tpu_torch.models import simulator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import os, sys, tempfile
import axctdprocessor_tpu_torch
print("TORCH_AFTER_PACKAGE_IMPORT", "torch" in sys.modules)
import torch
torch.set_num_threads(2)
from axctdprocessor_tpu_torch import cli
from axctdprocessor_tpu_torch.models import engine, segmented, simulator
from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder
from axctdprocessor_tpu_torch.parallel import batch, multihost, timeshard
from axctdprocessor_tpu_torch.parallel.mesh import make_mesh
from axctdprocessor_tpu_torch.utils import report
spec = simulator.SimSpec(duration=40.0, profile_start=33.0, seed=3)
pcm, truth = simulator.synthesize(spec)
raw = (pcm * (28000 / abs(pcm).max())).astype("int16")
res = engine.decode_waveform(raw, spec.fs, device="cpu")
seg = engine.decode_waveform(raw, spec.fs, device="cpu", mode="segmented")
staged = segmented.prestage_waveform(raw, spec.fs, device="cpu", fused=True).decode()
stream = DeviceStreamDecoder(spec.fs, device="cpu")
stream.feed(pcm / abs(pcm).max())
rows = batch.decode_batch(raw[None], spec.fs, device="cpu")
int4 = engine.decode_waveform(raw, spec.fs, device="cpu", wire="int4", lossy_retry=False)
cond = (pcm - pcm.mean()) / abs(pcm).max()
parity = axctdprocessor_tpu_torch.decode_waveform_parity(cond, spec.fs)
host_stream = axctdprocessor_tpu_torch.AXCTDStreamDecoder(spec.fs)
host_stream.feed(cond)
piped = axctdprocessor_tpu_torch.decode_batches_pipelined(
    [(raw[None], None), (raw[None], None)], spec.fs, device="cpu")
cpus = [torch.device("cpu")] * 2
sharded = timeshard.decode_batch_timesharded(raw[None], spec.fs,
                                             mesh=make_mesh({"dp": 1, "sp": 2}, cpus))
meshed = batch.decode_batch(raw[None], spec.fs, mesh=make_mesh({"dp": 2}, cpus))
assert meshed[0].hexframes == rows[0].hexframes
with tempfile.TemporaryDirectory() as d:
    wavs = [os.path.join(d, f"drop{i}.wav") for i in range(2)]
    for w in wavs:
        simulator.write_wav(w, pcm, spec.fs)
    manifest = axctdprocessor_tpu_torch.reprocess_corpus(
        wavs, os.path.join(d, "out"), batch_size=2, device="cpu")
    assert [e["status"] for e in manifest["files"].values()] == ["done", "done"]
    hosted = multihost.reprocess_corpus_multihost(
        wavs[:1], os.path.join(d, "hosted"), batch_size=2, device="cpu")
    assert [e["status"] for e in hosted["files"].values()] == ["done"]
    assert cli.main(["-i", wavs[0], "-o", os.path.join(d, "parity.txt"), "--quiet",
                     "--engine", "parity"]) == 0
for r in (res, seg, staged, stream.finalize(), rows[0], int4, parity,
          host_stream.finalize(), piped[0][0], piped[1][0], sharded[0], meshed[0]):
    assert r.status == 2, r.status
    assert r.metadata["serial_no"] == truth["serial_no"]
    assert len(r.hexframes) > 100
for name in axctdprocessor_tpu_torch._EXPORTS:
    assert getattr(axctdprocessor_tpu_torch, name).__name__
assert axctdprocessor_tpu_torch.decode_wav is engine.decode_wav
assert axctdprocessor_tpu_torch.DeviceStreamDecoder is DeviceStreamDecoder
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
loaded = sorted(m for m in sys.modules
                if m == "axctdprocessor_tpu" or m.startswith("axctdprocessor_tpu."))
print("JAX_PACKAGE_MODULES", loaded)
"""


def _child_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


def test_port_decodes_without_loading_jax():
    out = subprocess.run([sys.executable, "-c", _CHILD], env=_child_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "TORCH_AFTER_PACKAGE_IMPORT False" in out.stdout, out.stdout[-2000:]
    assert "JAX_MODULES []" in out.stdout, out.stdout[-2000:]
    assert "JAX_PACKAGE_MODULES []" in out.stdout, out.stdout[-2000:]


_PARITY_CHILD = """
import os, sys, tempfile
from axctdprocessor_tpu_torch import cli
from axctdprocessor_tpu_torch.models import simulator
spec = simulator.SimSpec(duration=38.0, profile_start=33.0, seed=3)
pcm, truth = simulator.synthesize(spec)
with tempfile.TemporaryDirectory() as d:
    wav, out = os.path.join(d, "drop.wav"), os.path.join(d, "report.txt")
    simulator.write_wav(wav, pcm, spec.fs)
    assert cli.main(["-i", wav, "-o", out, "--engine", "parity", "--quiet"]) == 0
    assert "Probe Serial: " + truth["serial_no"] in open(out).read()
print("LOADED", sorted(m for m in sys.modules
                       if m.split(".")[0] in ("torch", "jax", "jaxlib", "axctdprocessor_tpu")))
"""


def test_parity_cli_never_imports_torch():
    """``--engine parity`` is host numpy and scipy: a fresh interpreter that
    synthesizes a short WAV and decodes it through the CLI's parity engine
    ends with neither torch nor jax nor the JAX package loaded."""
    out = subprocess.run([sys.executable, "-c", _PARITY_CHILD], env=_child_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout[-2000:]


@pytest.mark.parametrize("module", [
    "ops.crc", "ops.iir", "ops.bits", "ops.seawater", "ops.wire", "models.frames",
    "models.simulator", "models.demod", "models.parity_engine", "models.stream",
    "utils.profiling", "utils.native", "cli"])
def test_host_module_imports_without_torch(module):
    """The modules the host parity path imports keep torch out of their
    import: their device functions import it when called."""
    code = (f"import sys, axctdprocessor_tpu_torch.{module}; "
            "print('TORCH', 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], env=_child_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "TORCH False" in out.stdout, module


def _imports(path):
    """Every module name a file imports, relative imports resolved."""
    rel = os.path.relpath(path, REPO)
    package = os.path.dirname(rel).replace(os.sep, ".")
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[: len(package.split(".")) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


PORT_FILES = sorted(glob.glob(os.path.join(REPO, "axctdprocessor_tpu_torch", "**", "*.py"),
                              recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_file_of_the_port_imports_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m == "jax" or m.startswith("jax.")
           or m == "axctdprocessor_tpu" or m.startswith("axctdprocessor_tpu.")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


_BUILD_CHILD = """
import json, os, subprocess
from axctdprocessor_tpu_torch.utils import native
written = []
real_run = subprocess.run
def run(cmd, *a, **k):
    written.append(cmd[cmd.index("-o") + 1])
    return real_run(cmd, *a, **k)
native.subprocess.run = run
if os.path.exists(native.LIB_PATH):
    os.utime(native.SOURCE)  # the source is newer: the loader rebuilds
lib = native.get_library()
print("BUILT " + json.dumps(dict(loaded=lib is not None, written=written)))
"""


def test_native_library_builds_only_under_the_port_build_dir():
    """The loader compiles the port's copy of wavio.cpp into
    ``axctdprocessor_tpu_torch/_build/`` (through a temporary name there),
    loads it from there, and leaves the JAX package's directory alone."""
    from axctdprocessor_tpu_torch.utils import native

    build = os.path.join(REPO, "axctdprocessor_tpu_torch", "_build")
    assert native.BUILD_DIR == build
    assert os.path.dirname(native.LIB_PATH) == build
    assert native.SOURCE == os.path.join(REPO, "axctdprocessor_tpu_torch", "native", "wavio.cpp")
    jax_native = os.path.join(REPO, "axctdprocessor_tpu", "native")
    before = {p: os.stat(p).st_mtime_ns for p in glob.glob(os.path.join(jax_native, "*"))}
    out = subprocess.run([sys.executable, "-c", _BUILD_CHILD], env=_child_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines() if ln.startswith("BUILT "))
    built = json.loads(line[len("BUILT "):])
    if not built["loaded"]:
        pytest.skip("no C++ compiler for the native library")
    written = built["written"]
    assert written and all(os.path.dirname(p) == build for p in written), written
    assert os.path.exists(native.LIB_PATH)
    after = {p: os.stat(p).st_mtime_ns for p in glob.glob(os.path.join(jax_native, "*"))}
    assert after == before


@pytest.mark.parametrize("spec", [
    dict(duration=20.0, seed=4),
    dict(fs=16000, duration=36.0, profile_start=30.0, noise_rms=0.05, seed=9),
])
def test_simulator_copy_synthesizes_the_same_drop(spec):
    pcm, truth = simulator.synthesize(simulator.SimSpec(**spec))
    jpcm, jtruth = jsim.synthesize(jsim.SimSpec(**spec))
    np.testing.assert_array_equal(pcm, jpcm)
    assert truth["frame_hex"] == jtruth["frame_hex"]
    np.testing.assert_array_equal(truth["header_frames"], jtruth["header_frames"])
    assert truth["tcoeff"] == jtruth["tcoeff"]
