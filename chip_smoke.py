"""On-card smoke run of the PyTorch port (axctdprocessor_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one line each or more (any failure raises and exits non-zero):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   no GPU -> exit 1 before anything else;
1. build the hand-written CUDA kernel and the wire encoders' C library
   from the sources in the checkout (both into
   ``axctdprocessor_tpu_torch/_build/``), time the builds and say which
   encoder runs; then synthesize the drops once: the 600 s bench drop
   (simulator seed 11) as an int16 WAV, and the bench's 64 x 60 s int16
   archive batch;
2. the kernel against its plain PyTorch version on the card, rtol = atol =
   2e-4 with equal NaN positions (the Pallas kernel's own test tolerance):
   a 600 s 44.1 kHz tone-plus-noise signal, a length that is no multiple of
   the stride, a zero-padded tail, a 16 kHz case, a 22.05 kHz case (stride
   882: tiles not 16-byte aligned), a batch of 3 rows whose n is no
   multiple of 4, then the batch path's input (the conditioned archive
   batch) as B = 8 and B = 64 rows of 60 s; each batch row bitwise equal to
   the 1-D kernel.  Per shape: median CUDA-event times per call over 20
   runs of 10 back-to-back calls after a warm-up, kernel and plain in
   turns; the bound (the
   bytes at 3.35 TB/s against the flop at 66.9 TFLOP/s) and the share of
   it the kernel reaches; and, for reference only, one ``torch.matmul`` of
   the tile view by the segment matrix (the DFT core alone);
3. the monolithic path end to end: the 600 s WAV through
   ``decode_wav(device="cuda", mode="monolithic")``; held to the
   simulator's truth, to the same decode with the plain tone-ratio
   version, and (on the 50 s default drop) to the CPU decode; the kernel's
   launch count is read around the first decode only;
4. a 42 s drop at 88.2 kHz (on-card decimation), metadata against truth;
5. the port's CLI in a subprocess on the 600 s WAV (``"auto"``: the
   segmented engine);
6. the segmented engine: the 600 s WAV through ``decode_wav`` (``"auto"``
   routes it there), the same gates, agreement with the monolithic decode,
   warm walls and host syncs;
7. prestaged: ``prestage_waveform(wire="int8")`` then ``decode()``, warm
   walls, sustained throughput of 8 queued decodes, ``fused=True`` equal;
8. the stream decoder fed the 600 s drop in 1 s float blocks: ``finalize()``
   equal to the offline segmented decode of the same samples;
9. the batch path: the archive batch through ``decode_batch`` as one batch
   of 64 and as 8 of 8; every row's status and serial, one kernel launch
   per call, walls, peak device memory and host syncs;
10. ``torch.profiler`` last, after every wall (a process that has run the
   profiler launches more slowly from then on): one segmented decode and
   one batch of 64 (launches, device idle share, the upload), then the
   kernel's device time at each phase-2 shape.

Each path is driven with the kernel's launch count set to 0 just before
and read just after.  At the end neither jax nor any module of the JAX
package (``axctdprocessor_tpu``) may be loaded.  Then come the line
``{"kernels": [...]}`` (per shape: times, bound and share of bound), the
card's name and power limit, and, last, ``{"ok": true, "device": {...}}``.
Temporary WAVs live in a directory inside the checkout that is removed at
the end.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

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
    from axctdprocessor_tpu_torch.utils import native

    t0 = time.perf_counter()
    kernels.extension()
    dt = time.perf_counter() - t0
    log(f"[1] built tone_ratios ({KERNEL_SOURCE}, sm_90a) in {dt:.1f} s")
    t0 = time.perf_counter()
    lib = native.get_library()
    dt = time.perf_counter() - t0
    log("[1] wire encoders: " + (
        f"the C library ({os.path.relpath(native.LIB_PATH, ROOT)}, built from "
        f"{os.path.relpath(native.SOURCE, ROOT)} in {dt:.1f} s)" if lib is not None
        else "numpy (no g++, or AXCTD_NO_NATIVE set)"))


def archive_batch() -> dict:
    """The bench's archive batch (``bench.py:132-150``): one simulated 60 s
    drop (seed 21, profile at 40 s) plus independent noise per row (rng
    seed 7), 64 int16 rows."""
    from axctdprocessor_tpu_torch.models import simulator

    rng = np.random.default_rng(7)
    bspec = simulator.SimSpec(duration=60.0, profile_start=40.0, seed=21)
    bpcm, btruth = simulator.synthesize(bspec)
    base = np.round(bpcm * (28000 / np.max(np.abs(bpcm)))).astype(np.int16)
    rows = np.stack([np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
                     .astype(np.int16) for _ in range(64)])
    return dict(batch=rows, batch_truth=btruth, batch_fs=bspec.fs)


def phase1_drops(tmp: str) -> dict:
    """The 600 s bench drop as a WAV (``bench.py:104``) and the bench's
    archive batch."""
    from axctdprocessor_tpu_torch.models import simulator

    t0 = time.perf_counter()
    spec = simulator.SimSpec(duration=600.0, profile_start=33.0, seed=11)
    pcm, truth = simulator.synthesize(spec)
    wav = os.path.join(tmp, "bench_600s.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    del pcm
    batch = archive_batch()
    log(f"[1] synthesized the 600 s bench drop and the 64 x 60 s archive batch in "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(wav=wav, truth=truth, fs=spec.fs, **batch)


@contextlib.contextmanager
def count_syncs():
    """Counts the operations that make the host wait for the card
    (``torch.cuda.set_sync_debug_mode``; it sees PyTorch's own waits, not
    the driver's)."""
    box = {}
    # switched on outside the recording: the first switch in a process
    # raises one warning of its own
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            yield box
        finally:
            torch.cuda.set_sync_debug_mode("default")
            box["n"] = sum("synchroniz" in str(w.message) for w in caught)


def profile_run(fn) -> str:
    """One run of `fn` under ``torch.profiler``: wall, kernel launches,
    device busy time (union of device activity) and idle share, and the
    host-to-device copies by kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    launches = sum(e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel")) for e in events)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -1e30
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    h2d = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and "HtoD" in e.name:
            n, us = h2d.get(e.name, (0, 0.0))
            h2d[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        return f"profiled wall {wall_us / 1e3:.1f} ms, launches {launches}; device time not measured"
    return (f"profiled wall {wall_us / 1e3:.1f} ms, kernel launches {launches}, device busy "
            f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}, H2D "
            + ("; ".join(f"{k}: {n} copies {us / 1e3:.2f} ms" for k, (n, us) in h2d.items())
               or "none"))


HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
F32_FLOP_PER_S = 66.9e12   # H100 SXM f32 on the CUDA cores


def _event_ms(fn, calls: int = 1) -> float:
    """CUDA-event time per call over `calls` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _time_pair(kernel, plain) -> tuple[float, float]:
    """Median CUDA-event times per call of `kernel` and `plain` over 20 runs
    of 10 back-to-back calls each, in turns, after a warm-up."""
    for _ in range(3):
        kernel()
        plain()
    k_ms, p_ms = [], []
    for _ in range(20):
        k_ms.append(_event_ms(kernel, 10))
        p_ms.append(_event_ms(plain, 10))
    return statistics.median(k_ms), statistics.median(p_ms)


def _device_ms(fn, name: str, calls: int = 20):
    """Mean device time of the kernels whose name holds `name` over `calls`
    calls, from ``torch.profiler`` (None if it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if name in e.key and e.count:
            return e.device_time_total / e.count / 1e3
    return None


def _bound(rows: int, n: int, window: int, n_win: int) -> tuple[float, str]:
    """The least time the card could take for the kernel's work: each input
    read once (the samples and the (window, 6) table), each output written
    once, against six length-`window` dot products (2 flop per multiply-add)
    plus the box mean and ratios (~30 flop) per window."""
    nbytes = 4 * (rows * n + window * 6 + 2 * rows * n_win)
    flop = rows * n_win * (12 * window + 30)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _max_err(got, ref, name) -> float:
    errs = []
    for g, r in zip(got, ref):
        g, r = g.cpu().numpy(), r.cpu().numpy()
        assert g.shape == r.shape, name
        assert np.array_equal(np.isnan(g), np.isnan(r)), f"{name}: NaN positions differ"
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)
        fin = np.isfinite(g)
        errs.append(float(np.max(np.abs(g[fin] - r[fin]))) if fin.any() else 0.0)
    return max(errs)


def _rows_bitwise(xb, got, one_call, name) -> None:
    """Each row of the batch call's outputs `got` bitwise equal to
    `one_call` (the 1-D kernel) on that row."""
    for r in range(xb.shape[0]):
        one = one_call(xb[r])
        for g, o in zip(got, one):
            assert torch.equal(torch.nan_to_num(g[r], nan=7.0), torch.nan_to_num(o, nan=7.0)), \
                f"{name}: row {r} differs from the 1-D kernel"


def _dft_core_ms(x, tm, window: int, stride: int) -> float:
    """One ``torch.matmul`` (f32, TF32 off) of the (n_tiles, stride) tile view
    by the (stride, 18) segment matrix: the DFT core alone, not the same
    function (no shifted adds, magnitudes, box mean or ratios), to show what
    cuBLAS reaches on the same bytes."""
    n = x.shape[-1]
    n_tiles = n // stride
    tiles = x[..., : n_tiles * stride].reshape(-1, stride)
    segs = torch.zeros((3, stride, 6), device=x.device)
    for j in range(3):
        seg = tm[j * stride: min((j + 1) * stride, window)]
        segs[j, : seg.shape[0]] = seg
    seg_mat = segs.permute(1, 0, 2).reshape(stride, 18).contiguous()
    for _ in range(3):
        torch.matmul(tiles, seg_mat)
    return statistics.median(_event_ms(lambda: torch.matmul(tiles, seg_mat), 10)
                             for _ in range(20))


def _kernel_cases(drops: dict) -> list:
    """(name, input on the card, fs) of every shape the kernel is held to;
    built anew by each phase that needs them (the same data each time), so
    that no phase keeps them alive on the card for the next."""
    from axctdprocessor_tpu_torch.models import engine

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def tone_signal(fs, n, tail):
        t = np.arange(n) / fs
        x = (0.4 * np.sin(2 * np.pi * 400.0 * t) + 0.2 * np.sin(2 * np.pi * 7500.0 * t)
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
        if tail:
            x[int(n * (1 - tail)):] = 0.0
        return torch.from_numpy(x).to(dev)

    # the batch path's input is the archive batch conditioned on the card
    cases = [
        ("600 s 44.1 kHz", tone_signal(44100.0, int(600 * 44100), 0.0), 44100.0),
        ("ragged 50 s", tone_signal(44100.0, int(50 * 44100) + 777, 0.0), 44100.0),
        ("zero tail 60 s", tone_signal(44100.0, int(60 * 44100), 0.25), 44100.0),
        ("16 kHz 45 s", tone_signal(16000.0, int(45 * 16000), 0.1), 16000.0),
        ("22.05 kHz 120 s (stride 882)", tone_signal(22050.0, int(120 * 22050), 0.1), 22050.0),
        ("batch 3 x (50 s + 777), n % 4 = 1",
         torch.stack([tone_signal(44100.0, int(50 * 44100) + 777, tail)
                      for tail in (0.0, 0.1, 0.3)]), 44100.0),
    ]
    rows = torch.from_numpy(drops["batch"]).to(dev)
    n = rows.shape[1]
    cond = engine.condition_integer(rows, n, torch.full((rows.shape[0],), n, device=dev))
    return cases + [(f"batch {b} x 60 s (conditioned archive rows)", cond[:b].contiguous(),
                     drops["batch_fs"]) for b in (8, 64)]


def _table(fs: float):
    from axctdprocessor_tpu_torch.ops import goertzel

    window, stride = int(fs / 10), int(round(fs / 25))
    tm = torch.from_numpy(goertzel.tone_matrix(
        window, [400.0, 7500.0, 3000.0], fs, dtype=np.float32)).cuda()
    return window, stride, tm


def phase2_kernel(drops: dict) -> dict:
    from axctdprocessor_tpu_torch.ops import tonepower

    worst, shapes = 0.0, []
    for name, xd, fs in _kernel_cases(drops):
        window, stride, tm = _table(fs)
        got = tonepower.tone_ratios(xd, tm, window, stride)
        ref = tonepower.tone_ratios_reference(xd, tm, window, stride)
        n_win = tonepower.n_windows(xd.shape[-1], window, stride)
        assert got[0].shape == xd.shape[:-1] + (n_win,), name
        err = _max_err(got, ref, name)
        worst = max(worst, err)
        if xd.dim() == 2:
            _rows_bitwise(xd, got, lambda row: tonepower.tone_ratios(row, tm, window, stride),
                          name)
        km, pm = _time_pair(lambda: tonepower.tone_ratios(xd, tm, window, stride),
                            lambda: tonepower.tone_ratios_reference(xd, tm, window, stride))
        rows_n = xd.shape[0] if xd.dim() == 2 else 1
        bound_ms, bound_by = _bound(rows_n, xd.shape[-1], window, n_win)
        core_ms = _dft_core_ms(xd, tm, window, stride)
        rec = dict(shape=name, rows=rows_n, n=int(xd.shape[-1]), stride=stride, n_win=n_win,
                   max_abs_err=err, ms=km, device_ms=None, plain_ms=pm,
                   bound_us=1e3 * bound_ms, bound_by=bound_by, share_of_bound=bound_ms / km,
                   dft_core_matmul_ms=core_ms)
        shapes.append(rec)
        log(f"[2] {name}: rows {rows_n} n={rec['n']} stride {stride} n_win={n_win} NaN windows="
            f"{int(torch.isnan(got[0]).sum())} max_abs_err={err:.3g} (rtol=atol={RTOL})"
            + (", every row bitwise equal to the 1-D kernel" if xd.dim() == 2 else "")
            + f"; kernel {km:.4f} ms"
            f", plain {pm:.4f} ms, bound {rec['bound_us']:.1f} us ({bound_by}), share of "
            f"bound {rec['share_of_bound']:.3f}; for reference only, one torch.matmul of the "
            f"tile view by the (stride, 18) segment matrix (the DFT core alone, not the same "
            f"function): {core_ms:.4f} ms")
    return dict(max_abs_err=worst, shapes=shapes)


def phase10_profiles(drops: dict, seg: dict, k: dict) -> None:
    """``torch.profiler`` runs, after every wall: a process that has run the
    profiler launches kernels more slowly from then on, which would load the
    walls of phases 3-9.  One segmented decode and one batch of 64, then the
    kernel's device time at each phase-2 shape."""
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch

    raw, fs = seg["raw"], seg["fs"]
    log("[10] 600 s segmented decode: "
        + profile_run(lambda: segmented.decode_waveform_segmented(raw, fs, device="cuda")))
    log("[10] batch 1 x 64 x 60 s: "
        + profile_run(lambda: batch.decode_batch(drops["batch"], drops["batch_fs"],
                                                 device="cuda")))
    for rec, (_, xd, fs) in zip(k["shapes"], _kernel_cases(drops)):
        window, stride, tm = _table(fs)
        rec["device_ms"] = _device_ms(lambda: tonepower.tone_ratios(xd, tm, window, stride),
                                      "tone_ratios_kernel")
        rec["share_of_bound_device"] = (rec["bound_us"] / 1e3 / rec["device_ms"]
                                        if rec["device_ms"] else None)
    log("[10] kernel device time (torch.profiler, mean of 20 calls): " + "; ".join(
        f"{r['shape']}: " + ("not measured" if r["device_ms"] is None else
                             f"{r['device_ms']:.4f} ms, share of bound "
                             f"{r['share_of_bound_device']:.3f}") for r in k["shapes"]))


def _agreement(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


def _gates(res, truth) -> float:
    """The 600 s drop's gates; returns the share of hexframes in the truth."""
    assert res.status == 2, res.status
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    assert res.overflow == 0, res.overflow
    assert len(res.time) > 1000, len(res.time)
    truth_set = set(truth["frame_hex"])
    in_truth = sum(h in truth_set for h in res.hexframes) / len(res.hexframes)
    assert in_truth > 0.97, in_truth
    return in_truth


def _walls(fn, k: int) -> list[float]:
    out = []
    for _ in range(k):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase3_end_to_end(drops: dict) -> dict:
    from axctdprocessor_tpu_torch.models import engine, simulator
    from axctdprocessor_tpu_torch.ops import tonepower

    wav, truth = drops["wav"], drops["truth"]
    torch.cuda.reset_peak_memory_stats()
    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    res = engine.decode_wav(wav, device="cuda", mode="monolithic")
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert launches >= 1, "the monolithic path did not launch the tone_ratios kernel"
    in_truth = _gates(res, truth)

    plain = engine.decode_wav(wav, device="cuda", mode="monolithic", use_kernel=False)
    agree_plain = _agreement(res.hexframes, plain.hexframes)
    assert agree_plain >= 0.99, agree_plain

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = engine.decode_wav(wav, device="cuda", mode="monolithic")
        walls.append(time.perf_counter() - t0)
    agree_repeat = _agreement(again.hexframes, res.hexframes)
    assert agree_repeat >= 0.99, agree_repeat
    wall = statistics.median(walls)

    small, small_truth = simulator.synthesize()
    cpu = engine.decode_waveform(small, small_truth["spec"].fs, device="cpu")
    gpu = engine.decode_waveform(small, small_truth["spec"].fs, device="cuda")
    agree_cpu = _agreement(gpu.hexframes, cpu.hexframes)
    assert gpu.metadata == cpu.metadata and agree_cpu >= 0.99, agree_cpu

    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(wav)
    with count_syncs() as syncs:
        engine.decode_waveform(raw, fs, device="cuda", mode="monolithic")
    log(f"[3] 600 s monolithic decode on the card: status {res.status}, serial "
        f"{res.metadata['serial_no']}, probe {res.metadata['probe_code']}, max depth "
        f"{res.metadata['max_depth']}, overflow {res.overflow}, rows {len(res.time)}, "
        f"frames {len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the "
        f"plain-tone-ratio decode {agree_plain:.4f}, repeat agreement {agree_repeat:.4f}; "
        f"tone_ratios launches {launches}")
    log(f"[3] first decode {first_s:.3f} s, warm wall (median of 3) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, realtime factor {600.0 / wall:.1f}x, "
        f"peak device memory {peak_gib:.2f} GiB, host syncs per decode {syncs['n']}")
    log(f"[3] 50 s default drop: CUDA vs CPU decode hexframe agreement "
        f"{agree_cpu:.4f}, metadata equal, frames {len(gpu.hexframes)}/{len(cpu.hexframes)}")
    return dict(launches=launches, hexframes=res.hexframes, wall=wall)


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
    """The CLI decodes with mode "auto": the 600 s WAV takes the segmented
    engine."""
    out = os.path.join(tmp, "report.txt")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav,
                    "-o", out, "--device", "cuda", "--quiet"],
                   cwd=ROOT, check=True, timeout=600)
    text = open(out).read()
    assert "Probe Serial: 00123456" in text
    log(f"[5] CLI subprocess (segmented engine under \"auto\"): report of {text.count(chr(10))} lines, serial found, "
        f"{time.perf_counter() - t0:.1f} s")


def phase6_segmented(drops: dict, mono: dict) -> dict:
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import tonepower

    wav, truth = drops["wav"], drops["truth"]
    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    res = engine.decode_wav(wav, device="cuda")  # "auto": 600 s > 300 s
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    assert launches == 0, "the segmented path has no tone-ratio kernel"
    in_truth = _gates(res, truth)
    agree_mono = _agreement(res.hexframes, mono["hexframes"])
    assert agree_mono >= 0.99, agree_mono
    walls = _walls(lambda: engine.decode_wav(wav, device="cuda"), 3)
    wall = statistics.median(walls)
    raw, fs = read_wav_raw16(wav)
    timer = StageTimer()
    with count_syncs() as syncs:
        again = segmented.decode_waveform_segmented(raw, fs, device="cuda", timer=timer)
    assert again.hexframes == res.hexframes
    log(f"[6] 600 s segmented decode (decode_wav, \"auto\"): status {res.status}, serial "
        f"{res.metadata['serial_no']}, overflow {res.overflow}, rows {len(res.time)}, frames "
        f"{len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the monolithic "
        f"decode {agree_mono:.4f}; tone_ratios launches {launches}")
    log(f"[6] first decode {first_s:.3f} s, warm wall (median of 3) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]} vs monolithic {mono['wall']:.4f} s, realtime "
        f"factor {600.0 / wall:.1f}x, host syncs per decode {syncs['n']}; stages "
        f"{ {k: round(v * 1e3, 2) for k, v in timer.totals.items()} } ms")
    return dict(raw=raw, fs=fs, res=res)


def phase7_prestaged(drops: dict, seg: dict) -> None:
    from axctdprocessor_tpu_torch.models import segmented

    raw, fs, truth = seg["raw"], seg["fs"], drops["truth"]
    t0 = time.perf_counter()
    st = segmented.prestage_waveform(raw, fs, device="cuda", wire="int8")
    stage_s = time.perf_counter() - t0
    res = st.decode()
    in_truth = _gates(res, truth)
    agree = _agreement(res.hexframes, seg["res"].hexframes)
    assert agree >= 0.99, agree
    walls = _walls(st.decode, 5)
    wall = statistics.median(walls)
    k = 8
    t0 = time.perf_counter()
    outs = [st.dispatch() for _ in range(k)]
    finished = [st.finish(o) for o in outs]
    sustained = (time.perf_counter() - t0) / k
    assert all(f.hexframes == res.hexframes for f in finished)
    with count_syncs() as syncs:
        st.decode()
    fused = segmented.prestage_waveform(raw, fs, device="cuda", wire="int8", fused=True)
    res_f = fused.decode()
    assert res_f.hexframes == res.hexframes and res_f.time == res.time, "fused != unfused"
    assert res_f.metadata == res.metadata
    f_wall = statistics.median(_walls(fused.decode, 5))
    log(f"[7] prestaged 600 s (int8 wire, staged in {stage_s:.3f} s): status {res.status}, "
        f"frames {len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the streamed "
        f"segmented decode {agree:.4f}; warm wall (median of 5) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, sustained {sustained:.4f} s per decode over {k} "
        f"queued decodes ({600.0 / sustained:.1f}x realtime), host syncs per decode "
        f"{syncs['n']}; fused=True equal to fused=False, warm wall {f_wall:.4f} s")


def phase8_stream(drops: dict) -> None:
    from axctdprocessor_tpu_torch.utils.wavio import read_wav
    from axctdprocessor_tpu_torch.models import segmented
    from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

    pcm, fs = read_wav(drops["wav"])
    offline = segmented.decode_waveform_segmented(pcm, fs, device="cuda")
    _gates(offline, drops["truth"])
    dec = DeviceStreamDecoder(fs, device="cuda")
    step = int(fs)
    t_feed = time.perf_counter()
    for i in range(0, len(pcm), step):
        dec.feed(pcm[i: i + step])
    t0 = time.perf_counter()
    res = dec.finalize()
    tail_s = time.perf_counter() - t0
    feed_s = t0 - t_feed
    assert res.hexframes == offline.hexframes, "stream != offline segmented"
    assert res.time == offline.time and res.metadata == offline.metadata
    log(f"[8] stream: 600 s fed in 1 s float blocks ({feed_s:.3f} s of feeding, "
        f"{dec._next_k} segments); finalize() equal to the offline segmented decode "
        f"({len(res.hexframes)} frames, {len(res.time)} rows); last feed to finalize "
        f"{tail_s:.4f} s")


def phase9_batch(drops: dict) -> dict:
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch

    rows, fs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]

    def check(results, b):
        assert len(results) == b
        for r in results:
            assert r.status == 2, r.status
            assert r.metadata["serial_no"] == truth["serial_no"]

    out = {}
    for name, subs in (("1 x 64", [rows]), ("8 x 8", np.split(rows, 8))):
        batch.decode_batch(subs[0], fs, device="cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for sub in subs:
            tonepower.tone_ratios.launches = 0
            check(batch.decode_batch(sub, fs, device="cuda"), len(sub))
            assert tonepower.tone_ratios.launches == 1, tonepower.tone_ratios.launches
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = wall
        log(f"[9] batch {name} x 60 s int16: every row status 2 and serial = truth, one "
            f"tone_ratios launch per decode_batch call; wall {wall:.3f} s "
            f"({64 * 60.0 / wall:.1f}x realtime), peak device memory {peak:.2f} GiB")
    with count_syncs() as syncs:
        res_out, ctx = batch.dispatch_batch(rows, fs, device="cuda")
    n_dispatch = syncs["n"]
    check(batch.finish_dispatched(res_out, ctx), 64)
    log(f"[9] host syncs in dispatch_batch of 64: {n_dispatch} (the fetch in "
        f"finish_dispatched is the batch's one device-to-host copy)")
    return dict(launches=1)


def main() -> int:
    smi, kind = phase0_device()
    phase1_build()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        drops = phase1_drops(tmp)
        k = phase2_kernel(drops)
        mono = phase3_end_to_end(drops)
        phase4_highrate(tmp)
        phase5_cli(tmp, drops["wav"])
        seg = phase6_segmented(drops, mono)
        phase7_prestaged(drops, seg)
        phase8_stream(drops)
        bat = phase9_batch(drops)
        phase10_profiles(drops, seg, k)
    assert "jax" not in sys.modules, "the port loaded jax"
    loaded = [m for m in sys.modules
              if m == "axctdprocessor_tpu" or m.startswith("axctdprocessor_tpu.")]
    assert not loaded, f"the port loaded the JAX package: {loaded}"
    main_shape = k["shapes"][0]  # 600 s, the monolithic path's shape
    print(json.dumps({"kernels": [{
        "name": "tone_ratios", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": mono["launches"],
        "launches_per_decode_batch": bat["launches"],
        "max_abs_err": k["max_abs_err"], "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"], "bound_ms": main_shape["bound_us"] / 1e3,
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "bound_us": main_shape["bound_us"], "share_of_bound": main_shape["share_of_bound"],
        "shapes": [{key: s[key] for key in (
            "shape", "rows", "n", "stride", "n_win", "ms", "device_ms", "plain_ms", "bound_us",
            "bound_by", "share_of_bound", "share_of_bound_device", "dft_core_matmul_ms",
            "max_abs_err")}
            for s in k["shapes"]]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
