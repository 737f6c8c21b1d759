"""The port runs without jax: the machine with the GPU has none.

A fresh interpreter imports ``axctdprocessor_tpu_torch`` and decodes a
short drop on the CPU through each path (monolithic, segmented, prestaged,
stream and batch); jax must never enter ``sys.modules``.  The port's
jax-free simulator copy must synthesize the JAX package's drops exactly.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from axctdprocessor_tpu.models import simulator as jsim
from axctdprocessor_tpu_torch.models import simulator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
import torch
torch.set_num_threads(2)
import axctdprocessor_tpu_torch
from axctdprocessor_tpu_torch import cli
from axctdprocessor_tpu_torch.models import engine, segmented, simulator
from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder
from axctdprocessor_tpu_torch.parallel import batch
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
for r in (res, seg, staged, stream.finalize(), rows[0]):
    assert r.status == 2, r.status
    assert r.metadata["serial_no"] == truth["serial_no"]
    assert len(r.hexframes) > 100
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", loaded)
"""


def test_port_decodes_without_loading_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_MODULES []" in out.stdout, out.stdout[-2000:]


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
