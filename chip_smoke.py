"""On-card smoke run of the PyTorch port (axctdprocessor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   no GPU -> exit 1 before anything else;
1. build the hand-written CUDA kernel from the sources in the checkout
   (into ``axctdprocessor_tpu_torch/_build/``) and time the build;
2. the kernel against its plain PyTorch version on the card, rtol = atol =
   2e-4 with equal NaN positions (the Pallas kernel's own test tolerance):
   a 600 s 44.1 kHz tone-plus-noise signal, a length that is no multiple of
   the stride, a zero-padded tail and a 16 kHz case; median times over 20
   CUDA-event-timed runs after a warm-up, kernel and plain in turns;
3. the main path end to end: the 600 s bench drop (simulator seed 11)
   written as an int16 WAV and decoded with ``decode_wav(device="cuda")``;
   held to the simulator's truth, to the same decode with the plain
   tone-ratio version, and (on the 50 s default drop) to the CPU decode;
   the kernel's launch count is read around the first decode only;
4. a 42 s drop at 88.2 kHz (on-card decimation), metadata against truth;
5. the port's CLI in a subprocess on the bench WAV.

The line before last is ``{"kernels": [...]}`` and the last line is
``{"ok": true, "device": {...}}``.  Temporary WAVs live in a directory
inside the checkout that is removed at the end.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 2e-4  # tests/test_pallas_kernels.py:36, the Pallas kernel's own bar
KERNEL_SOURCE = "axctdprocessor_tpu_torch/ops/kernels/tone_ratios.cu"
REPLACES = "axctdprocessor_tpu/ops/pallas/tonepower.py:110"


def log(msg: str) -> None:
    print(msg, flush=True)


def phase0_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # a float32 reference in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[0] card {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()} | tf32 off")
    return smi, kind


def phase1_build() -> None:
    from axctdprocessor_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.extension()
    dt = time.perf_counter() - t0
    log(f"[1] built tone_ratios ({KERNEL_SOURCE}, sm_90a) in {dt:.1f} s")


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase2_kernel() -> dict:
    from axctdprocessor_tpu_torch.ops import goertzel, tonepower

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = [  # name, fs, samples, zero-padded tail fraction
        ("600 s 44.1 kHz", 44100.0, int(600 * 44100), 0.0),
        ("ragged 50 s", 44100.0, int(50 * 44100) + 777, 0.0),
        ("zero tail 60 s", 44100.0, int(60 * 44100), 0.25),
        ("16 kHz 45 s", 16000.0, int(45 * 16000), 0.1),
    ]
    worst = 0.0
    timing = None
    for name, fs, n, tail in cases:
        t = np.arange(n) / fs
        x = (0.4 * np.sin(2 * np.pi * 400.0 * t) + 0.2 * np.sin(2 * np.pi * 7500.0 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        if tail:
            x[int(n * (1 - tail)):] = 0.0
        window, stride = int(fs / 10), int(round(fs / 25))
        tm = torch.from_numpy(goertzel.tone_matrix(
            window, [400.0, 7500.0, 3000.0], fs, dtype=np.float32)).to(dev)
        xd = torch.from_numpy(x).to(dev)
        got = tonepower.tone_ratios(xd, tm, window, stride)
        ref = tonepower.tone_ratios_reference(xd, tm, window, stride)
        torch.cuda.synchronize()
        errs = []
        for g, r in zip(got, ref):
            g, r = g.cpu().numpy(), r.cpu().numpy()
            assert g.shape == r.shape == (tonepower.n_windows(n, window, stride),)
            assert np.array_equal(np.isnan(g), np.isnan(r)), f"{name}: NaN positions differ"
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, equal_nan=True,
                                       err_msg=name)
            fin = np.isfinite(g)
            errs.append(float(np.max(np.abs(g[fin] - r[fin]))) if fin.any() else 0.0)
        worst = max(worst, *errs)
        k_ms, p_ms = [], []
        for _ in range(3):  # warm-up
            tonepower.tone_ratios(xd, tm, window, stride)
            tonepower.tone_ratios_reference(xd, tm, window, stride)
        for _ in range(20):  # in turns
            k_ms.append(_event_ms(lambda: tonepower.tone_ratios(xd, tm, window, stride)))
            p_ms.append(_event_ms(lambda: tonepower.tone_ratios_reference(xd, tm, window, stride)))
        km, pm = statistics.median(k_ms), statistics.median(p_ms)
        log(f"[2] {name}: n={n} n_win={got[0].shape[0]} NaN windows="
            f"{int(torch.isnan(got[0]).sum())} max_abs_err={max(errs):.3g} "
            f"(rtol=atol={RTOL}) kernel {km:.4f} ms plain {pm:.4f} ms")
        if timing is None:
            timing = dict(ms=km, plain_ms=pm)
    return dict(max_abs_err=worst, **timing)


def _agreement(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


def phase3_end_to_end(tmp: str) -> dict:
    from axctdprocessor_tpu_torch.models import engine, simulator
    from axctdprocessor_tpu_torch.ops import tonepower

    t0 = time.perf_counter()
    spec = simulator.SimSpec(duration=600.0, profile_start=33.0, seed=11)
    pcm, truth = simulator.synthesize(spec)
    wav = os.path.join(tmp, "bench_600s.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    del pcm
    log(f"[3] synthesized the 600 s bench drop in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    res = engine.decode_wav(wav, device="cuda")
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert launches >= 1, "the main path did not launch the tone_ratios kernel"

    assert res.status == 2, res.status
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    assert res.overflow == 0, res.overflow
    assert len(res.time) > 1000, len(res.time)
    truth_set = set(truth["frame_hex"])
    in_truth = sum(h in truth_set for h in res.hexframes) / len(res.hexframes)
    assert in_truth > 0.97, in_truth

    plain = engine.decode_wav(wav, device="cuda", use_kernel=False)
    agree_plain = _agreement(res.hexframes, plain.hexframes)
    assert agree_plain >= 0.99, agree_plain

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = engine.decode_wav(wav, device="cuda")
        walls.append(time.perf_counter() - t0)
    agree_repeat = _agreement(again.hexframes, res.hexframes)
    assert agree_repeat >= 0.99, agree_repeat
    wall = statistics.median(walls)

    small, small_truth = simulator.synthesize()
    cpu = engine.decode_waveform(small, small_truth["spec"].fs, device="cpu")
    gpu = engine.decode_waveform(small, small_truth["spec"].fs, device="cuda")
    agree_cpu = _agreement(gpu.hexframes, cpu.hexframes)
    assert gpu.metadata == cpu.metadata and agree_cpu >= 0.99, agree_cpu

    log(f"[3] 600 s decode on the card: status {res.status}, serial "
        f"{res.metadata['serial_no']}, probe {res.metadata['probe_code']}, max depth "
        f"{res.metadata['max_depth']}, overflow {res.overflow}, rows {len(res.time)}, "
        f"frames {len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the "
        f"plain-tone-ratio decode {agree_plain:.4f}, repeat agreement {agree_repeat:.4f}; "
        f"tone_ratios launches {launches}")
    log(f"[3] first decode {first_s:.3f} s, warm wall (median of 3) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, realtime factor {600.0 / wall:.1f}x, "
        f"peak device memory {peak_gib:.2f} GiB")
    log(f"[3] 50 s default drop: CUDA vs CPU decode hexframe agreement "
        f"{agree_cpu:.4f}, metadata equal, frames {len(gpu.hexframes)}/{len(cpu.hexframes)}")
    return dict(wav=wav, launches=launches)


def phase4_highrate(tmp: str) -> None:
    from axctdprocessor_tpu_torch.models import engine, simulator

    spec = simulator.SimSpec(fs=88200, duration=42.0, profile_start=33.0, seed=31)
    pcm, truth = simulator.synthesize(spec)
    wav = os.path.join(tmp, "hi_88k.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    res = engine.decode_wav(wav, device="cuda")
    assert res.status == 2, res.status
    assert isinstance(res.fs, float) and res.fs == 44100.0, res.fs
    assert res.numpoints == (int(42.0 * 88200) + 1) // 2, res.numpoints
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    for key in ("tcoeff", "ccoeff", "zcoeff"):
        assert np.allclose(res.metadata[key], truth[key]), key
    log(f"[4] 88.2 kHz 42 s decode on the card: status {res.status}, fs {res.fs}, "
        f"serial {res.metadata['serial_no']}, frames {len(res.hexframes)}, "
        f"overflow {res.overflow}")


def phase5_cli(tmp: str, wav: str) -> None:
    out = os.path.join(tmp, "report.txt")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav,
                    "-o", out, "--device", "cuda", "--quiet"],
                   cwd=ROOT, check=True, timeout=600)
    text = open(out).read()
    assert "Probe Serial: 00123456" in text
    log(f"[5] CLI subprocess: report of {text.count(chr(10))} lines, serial found, "
        f"{time.perf_counter() - t0:.1f} s")


def main() -> int:
    smi, kind = phase0_device()
    phase1_build()
    k = phase2_kernel()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        e2e = phase3_end_to_end(tmp)
        phase4_highrate(tmp)
        phase5_cli(tmp, e2e["wav"])
    assert "jax" not in sys.modules, "the port loaded jax"
    print(json.dumps({"kernels": [{
        "name": "tone_ratios", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": e2e["launches"],
        "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
