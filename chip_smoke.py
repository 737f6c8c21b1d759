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
   multiple of 4, the 600 s bench drop as the lossy-wire paths hand it to
   the kernel (encoded on the host at int8 and at int4, unpacked and
   conditioned on the card), then the batch path's input (the conditioned
   archive batch) as B = 8 and B = 64 rows of 60 s; each batch row bitwise
   equal to the 1-D kernel.  Per shape: median CUDA-event times per call over 20
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
5. the port's CLI in a subprocess on the 600 s WAV with its defaults (the
   device engine on the card; ``"auto"``: the segmented engine), and the
   same command with no card visible, which must fail;
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
9a. the pipeline: the 64 rows as 8 batches of 8 through
   ``decode_batches_pipelined``; every row equal to phase 9's 8 x 8 row
   (hexframes, metadata, ``time``), one kernel launch per batch, the warm
   wall in turns with ``decode_batch`` batch by batch;
9b. the archive runner: the 64 rows as int16 WAVs plus one truncated file
   through ``reprocess_corpus(batch_size=8)``: 64 ``done``, 1 ``failed``,
   every report's bytes equal to ``write_report`` of phase 9a's row, one
   kernel launch per batch; ``resume=True`` decodes nothing; wall, drops
   per second and stage times; then the CLI's ``--corpus`` in a subprocess;
9c. the host parity engine: the CLI with ``--engine parity`` on the 50 s
   default drop in a subprocess, and hexframe agreement >= 0.99 of the
   card's monolithic decode with the parity decode, on that drop and on the
   600 s drop (the bench's gate, ``bench.py:207-215``);
9d. the multi-device paths on the one card: every mesh is built from an
   explicit device list that repeats ``cuda:0``.  The 600 s drop as a (1, n)
   int16 batch through ``decode_batch_timesharded`` on ``{"dp": 1, "sp": 4}``
   (phase 3's gates, agreement with phase 3's monolithic decode >= 0.99, no
   kernel launch: the time-sharded front end uses plain tone powers, as the
   JAX one; warm walls, host syncs, peak memory); 4 archive rows on
   ``{"dp": 2, "sp": 2}``; the first 16 archive rows through
   ``decode_batch(mesh={"dp": 2})``, every row equal to phase 9's, one
   kernel launch per ``dp`` run; 2 batches of 8 through
   ``decode_batches_pipelined(devices=[cuda:0, cuda:0])``, rows equal to
   phase 9a's;
9e. the lossy wires (int8, noise-shaped int4, the int8 retry) on the card:
   ``unpack_int4`` bit-equal and ``condition_integer`` within 1e-6 of the
   CPU on the host's encodings of the 600 s drop, an odd length and 8
   archive rows; the 600 s WAV through ``decode_wav(wire=w, mode=m)`` for
   the three wires and both modes (phase 3's gates, ``res.wire == w``,
   agreement with the int16 decode >= 0.99; warm walls in turns, the
   host's encode and upload-building times, H2D bytes and the time of one
   pinned copy of that size, peak device memory; at int4 the row-cap bit
   of ``overflow`` is reported and allowed, no other bit at any wire); the
   64 archive rows through ``decode_batch`` 8 x 8 at the three wires with
   ``lossy_retry=True`` (every row status 2 with the true serial, the rows
   decoded again at int8 and the kernel launches they cost, agreement with
   the int16 rows, three walls per wire in turns), the same at int4 through
   ``decode_batches_pipelined`` and ``reprocess_corpus`` (rows and report
   bytes equal to ``decode_batch``'s, the manifest's wire per file); one
   drop that collapses at int4 on the card through ``decode_waveform`` with
   the retry (int8, status 2, two kernel launches) and without (int4,
   degenerate); the CLI's ``--wire int4`` against the in-process decode;
9f. ``iir.sosfilt`` (the parallel scan form, float64) on one second of the
   600 s drop on the card against ``iir.sosfilt_fft`` and its CPU run;
10. ``torch.profiler`` last, after every wall (a process that has run the
   profiler launches more slowly from then on): one segmented, one
   monolithic and one time-sharded decode of the 600 s drop and
   one batch of 8 of the archive rows (launches, device idle share, the
   upload), one pipelined run of 2 x 8, then the kernel's device time at
   each phase-2 shape.

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


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """One line per finished phase with the seconds since the script began,
    so that a run shows where its time went."""
    log(f"[t] phase {phase} done at {time.perf_counter() - T0:.0f} s")


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
    # what the kernel sees on the lossy-wire paths: the 600 s bench drop
    # encoded on the host, then unpacked and conditioned on the card
    from axctdprocessor_tpu_torch.ops import wire as wire_ops
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, _ = read_wav_raw16(drops["wav"])
    n_raw = len(raw)
    for w in ("int8", "int4"):
        enc = torch.from_numpy(wire_ops.encode(raw, w)).to(dev)
        cases.append((f"600 s bench drop, {w} wire conditioned on the card",
                      engine.conditioned(enc, torch.full((), n_raw, device=dev))[:n_raw]
                      .contiguous(), 44100.0))
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
    walls of phases 3-9.  One segmented, one monolithic and one time-sharded
    decode, one batch of 8 rows and one pipelined run of 2 x 8, then the
    kernel's device time at each phase-2 shape."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

    raw, fs = seg["raw"], seg["fs"]
    log("[10] 600 s segmented decode: "
        + profile_run(lambda: segmented.decode_waveform_segmented(raw, fs, device="cuda")))
    log("[10] 600 s monolithic decode: "
        + profile_run(lambda: engine.decode_waveform(raw, fs, device="cuda",
                                                     mode="monolithic")))
    mesh = make_mesh({"dp": 1, "sp": 4}, [torch.device("cuda", 0)] * 4)
    log("[10] 600 s time-sharded decode, dp 1 x sp 4 on the one card: "
        + profile_run(lambda: timeshard.decode_batch_timesharded(raw[None], fs, mesh=mesh)))
    # 8 and 16 of the 64 rows: the launches per row and the idle share are
    # those of the whole batch, and the profiler's own bookkeeping of a
    # quarter of a million launches took half of this script's time
    log("[10] batch 1 x 8 x 60 s: "
        + profile_run(lambda: batch.decode_batch(drops["batch"][:8], drops["batch_fs"],
                                                 device="cuda")))
    batches = [(sub, None) for sub in np.split(drops["batch"][:16], 2)]
    log("[10] pipeline 2 x 8 x 60 s: "
        + profile_run(lambda: pipeline.decode_batches_pipelined(batches, drops["batch_fs"],
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


ROW_CAP_BIT = 1  # DecodeResult.overflow bit 0: stage 1 dropped crossings


def _gates(res, truth, allow_row_cap: bool = False) -> float:
    """The 600 s drop's gates; returns the share of hexframes in the truth.
    ``allow_row_cap`` lets the stage-1 truncation bit of ``overflow`` pass
    (the int4 wire only, see ``_wire_long_drop``); the edge-table and
    frame-sync bits never do."""
    assert res.status == 2, res.status
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key], (key, res.metadata[key])
    allowed = ROW_CAP_BIT if allow_row_cap else 0
    assert res.overflow & ~allowed == 0, res.overflow
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
    cmd = [sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav, "-o", out, "--quiet"]
    subprocess.run(cmd, cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    text = open(out).read()
    assert "Probe Serial: 00123456" in text
    # the defaults are the card's: with no card visible the same command fails
    blind = subprocess.run(cmd, cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
                           capture_output=True, text=True, timeout=600)
    assert blind.returncode != 0 and "cuda" in blind.stderr, blind.stderr[-500:]
    log(f"[5] CLI subprocess with its defaults (the device engine on the card; segmented "
        f"engine under \"auto\"): report of {text.count(chr(10))} lines, serial found, "
        f"{cli_s:.1f} s; with CUDA_VISIBLE_DEVICES empty the same command exits "
        f"{blind.returncode}")


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

    out, kept = {}, {}
    for name, subs in (("1 x 64", [rows]), ("8 x 8", np.split(rows, 8))):
        batch.decode_batch(subs[0], fs, device="cuda")  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kept[name] = []
        t0 = time.perf_counter()
        for sub in subs:
            tonepower.tone_ratios.launches = 0
            kept[name] += batch.decode_batch(sub, fs, device="cuda")
            assert tonepower.tone_ratios.launches == 1, tonepower.tone_ratios.launches
        wall = time.perf_counter() - t0
        check(kept[name], len(rows))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[name] = wall
        log(f"[9] batch {name} x 60 s int16: every row status 2 and serial = truth, one "
            f"tone_ratios launch per decode_batch call; wall {wall:.3f} s "
            f"({64 * 60.0 / wall:.1f}x realtime), peak device memory {peak:.2f} GiB")
    with count_syncs() as syncs:
        res_out, ctx = batch.dispatch_batch(rows, fs, device="cuda")
    n_dispatch = syncs["n"]
    check(batch.finish_dispatched(res_out, ctx), 64)
    log(f"[9] host syncs in dispatch_batch of 64: {n_dispatch} (it queues the batch's one "
        f"device-to-host copy on a side stream; finish_dispatched waits on that copy's event)")
    return dict(launches=1, rows_8x8=kept["8 x 8"], wall_8x8=out["8 x 8"])


def _rows_equal(got, want, truth, name) -> None:
    assert len(got) == len(want), (name, len(got), len(want))
    for i, (r, ref) in enumerate(zip(got, want)):
        assert r.status == 2 and r.overflow == 0, (name, i, r.status, r.overflow)
        assert r.metadata["serial_no"] == truth["serial_no"], (name, i)
        assert r.hexframes == ref.hexframes and r.metadata == ref.metadata, (name, i)
        assert r.time == ref.time, (name, i)


def phase9a_pipeline(drops: dict, bat: dict) -> dict:
    """The 64 rows as 8 batches of 8 through the two-stage pipeline; every
    row against the same row of phase 9's ``decode_batch`` 8 x 8 (the same
    card, kernel and arithmetic: equal)."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline

    rows, fs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]
    n_b = len(rows) // 8
    batches = [(sub, None) for sub in np.split(rows, n_b)]

    def run():
        return pipeline.decode_batches_pipelined(batches, fs, device="cuda")

    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    assert launches == n_b, f"{launches} tone_ratios launches for {n_b} pipelined batches"
    flat = [r for b in out for r in b]
    assert [len(b) for b in out] == [8] * n_b
    _rows_equal(flat, bat["rows_8x8"], truth, "pipeline")

    def plain():
        for sub, _ in batches:
            batch.decode_batch(sub, fs, device="cuda")

    walls, plain_walls = [], []
    for _ in range(3):  # in turns: decode_batch batch by batch, then the pipeline
        plain_walls += _walls(plain, 1)
        walls += _walls(run, 1)
    wall, plain_wall = statistics.median(walls), statistics.median(plain_walls)
    with count_syncs() as syncs:
        run()
    log(f"[9a] pipeline {n_b} x 8 x 60 s int16 (decode_batches_pipelined): {len(flat)} rows "
        f"status 2, serial = truth, overflow 0, hexframes, metadata and time equal to decode_batch "
        f"8 x 8 row for row; tone_ratios launches {launches} (one per batch)")
    log(f"[9a] first run {first_s:.3f} s, warm wall (median of 3) {wall:.3f} s "
        f"{[round(w, 3) for w in walls]} ({len(flat) * 60.0 / wall:.1f}x realtime) beside "
        f"decode_batch batch by batch in turns with it {plain_wall:.3f} s "
        f"{[round(w, 3) for w in plain_walls]} ({bat['wall_8x8']:.3f} s in phase 9); host "
        f"syncs seen by torch's sync debug mode in one run of {n_b} batches: {syncs['n']} "
        f"(the fetch waits on one CUDA event per batch, which that mode does not count)")
    return dict(launches=launches, rows=flat, wall=wall)


ECHO_DEAD = b"Dead frequency: 3000.0\n", b"Dead frequency: 3000\n"  # the CLI's -d is a float


def phase9b_archive(tmp: str, drops: dict, piped: dict) -> dict:
    """The 64 rows as WAVs plus one truncated file through the archive
    runner, against phase 9a's results; then resume, then the CLI."""
    from scipy.io import wavfile

    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.utils.config import resolve_settings
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer
    from axctdprocessor_tpu_torch.utils.report import write_report

    rows, fs = drops["batch"], int(drops["batch_fs"])
    corpus = os.path.join(tmp, "corpus")
    os.makedirs(corpus)
    paths = []
    for i, row in enumerate(rows):
        paths.append(os.path.join(corpus, f"row{i:02d}.wav"))
        wavfile.write(paths[-1], fs, row)
    nbytes = sum(os.path.getsize(p) for p in paths)
    cut = os.path.join(corpus, "truncated.wav")
    with open(paths[0], "rb") as f, open(cut, "wb") as g:
        g.write(f.read(30))  # ends inside the format chunk
    out_dir = os.path.join(tmp, "archive_out")
    timer = StageTimer()
    tonepower.tone_ratios.launches = 0
    with count_syncs() as syncs:
        t0 = time.perf_counter()
        manifest = reprocess_corpus(paths + [cut], out_dir, batch_size=8, device="cuda",
                                    timer=timer)
        wall = time.perf_counter() - t0
    launches = tonepower.tone_ratios.launches
    n = len(rows)
    assert launches == n // 8, f"{launches} tone_ratios launches for {n // 8} archive batches"
    status = {k: v["status"] for k, v in manifest["files"].items()}
    assert status.pop("truncated.wav") == "failed", manifest["files"]["truncated.wav"]
    assert len(status) == n and set(status.values()) == {"done"}, status
    cfg = resolve_settings(None)
    echo = {"minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500, "deadfreq": cfg.dead_freq,
            "pointsperloop": 100000, "triggerrange": list(cfg.trigger_range)}
    want = os.path.join(tmp, "want.txt")
    for path, res in zip(paths, piped["rows"]):
        write_report(want, res, path, [0, -1], echo, cfg)
        got = os.path.join(out_dir, os.path.basename(path)[:-4] + ".txt")
        assert open(got, "rb").read() == open(want, "rb").read(), path
        assert manifest["files"][os.path.basename(path)]["wire"] == "int16"

    again = StageTimer()
    tonepower.tone_ratios.launches = 0
    m2 = reprocess_corpus(paths, out_dir, batch_size=8, device="cuda", timer=again)
    assert tonepower.tone_ratios.launches == 0 and not again.counts, again.counts
    assert all(m2["files"][k]["finished_at"] == manifest["files"][k]["finished_at"]
               for k in status)

    cli_out = os.path.join(tmp, "archive_cli_out")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "--corpus", corpus,
                    "-o", cli_out, "--batch-size", "8", "--device", "cuda", "--quiet"],
                   cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    cli_manifest = json.load(open(os.path.join(cli_out, "manifest.json")))
    assert sorted(v["status"] for v in cli_manifest["files"].values()) == \
        ["done"] * n + ["failed"]
    for path in paths:
        name = os.path.basename(path)[:-4] + ".txt"
        assert open(os.path.join(cli_out, name), "rb").read().replace(*ECHO_DEAD) == \
            open(os.path.join(out_dir, name), "rb").read(), name
    stages = {k: round(v, 4) for k, v in timer.totals.items()}
    log(f"[9b] archive: {n} int16 WAVs of 60 s ({nbytes / 1e6:.0f} MB) + 1 truncated file, "
        f"reprocess_corpus(batch_size=8, device=\"cuda\"): {n} done, 1 failed, every report "
        f"byte-equal to write_report of the pipeline's row; tone_ratios launches {launches} "
        f"(one per batch); resume=True decoded nothing")
    log(f"[9b] wall {wall:.3f} s, {n / wall:.2f} drops/s ({n * 60.0 / wall:.1f}x realtime); "
        f"stage times (s) {stages}; host syncs seen by torch's sync debug mode in the whole "
        f"run: {syncs['n']} ({n // 8} batches; each fetch waits on one CUDA event, which that "
        f"mode does not count)")
    log(f"[9b] CLI subprocess (--corpus, --batch-size 8, --device cuda): {n} done, 1 failed, "
        f"reports equal to the API run's, {cli_s:.1f} s with interpreter start and kernel load")
    return dict(launches=launches, wall=wall)


def phase9c_parity(tmp: str, drops: dict, mono: dict) -> None:
    """The host parity engine through the CLI, and the bench's correctness
    gate: the card's decode against the parity decode."""
    from axctdprocessor_tpu_torch.models import engine, parity_engine, simulator

    pcm, truth = simulator.synthesize()
    wav = os.path.join(tmp, "default_50s.wav")
    simulator.write_wav(wav, pcm, truth["spec"].fs)
    out = os.path.join(tmp, "parity_report.txt")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav, "-o", out,
                    "--engine", "parity", "--quiet"], cwd=ROOT, check=True, timeout=600)
    cli_s = time.perf_counter() - t0
    text = open(out).read()
    assert "Probe Serial: 00123456" in text and text.count("\n") > 200
    par = parity_engine.decode_wav(wav)
    assert par.status == 2 and par.wire is None
    gpu = engine.decode_wav(wav, device="cuda", mode="monolithic")
    agree = _agreement(gpu.hexframes, par.hexframes)
    assert agree >= 0.99 and gpu.metadata == par.metadata, agree
    log(f"[9c] CLI subprocess (--engine parity, 50 s default drop, host only): report of "
        f"{text.count(chr(10))} lines, serial found, {cli_s:.1f} s; hexframe agreement of the "
        f"card's monolithic decode with the parity decode {agree:.4f} "
        f"({len(gpu.hexframes)}/{len(par.hexframes)} frames), metadata equal")
    t0 = time.perf_counter()
    par600 = parity_engine.decode_wav(drops["wav"])
    par_s = time.perf_counter() - t0
    assert par600.status == 2 and len(par600.hexframes) > 1000
    agree600 = _agreement(mono["hexframes"], par600.hexframes)
    assert agree600 >= 0.99, agree600
    log(f"[9c] 600 s bench drop: parity decode on the host {par_s:.1f} s, "
        f"{len(par600.hexframes)} frames; hexframe agreement of phase 3's monolithic decode "
        f"with it {agree600:.4f} (gate 0.99)")


def phase9d_multi_device(drops: dict, mono: dict, bat: dict, piped: dict) -> dict:
    """The mesh paths with every place of each mesh on the one card: what
    they compute and what they cost there.  A speed-up over several cards
    and the ordering of copies between two cards need more than one."""
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    card = torch.device("cuda", 0)
    log("[9d] one card: every mesh here is make_mesh(shape, [cuda:0] * k), the same device "
        "at every place, by the caller's explicit list")
    mesh = make_mesh({"dp": 1, "sp": 4}, [card] * 4)

    def long_drop():
        # WAV read to DecodeResult, as phase 3's decode_wav walls are
        raw, fs = read_wav_raw16(drops["wav"])
        return timeshard.decode_batch_timesharded(raw[None], fs, mesh=mesh)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    res = long_drop()
    first_s = time.perf_counter() - t0
    ts_launches = tonepower.tone_ratios.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    assert ts_launches == 0, "the time-sharded front end has no tone-ratio kernel"
    in_truth = _gates(res, drops["truth"])
    agree_mono = _agreement(res.hexframes, mono["hexframes"])
    assert agree_mono >= 0.99, agree_mono
    from axctdprocessor_tpu_torch.models import engine

    def mono_drop():
        return engine.decode_wav(drops["wav"], device="cuda", mode="monolithic")

    walls, mono_walls = [], []
    for _ in range(3):  # in turns: walls drift within a process
        mono_walls += _walls(mono_drop, 1)
        walls += _walls(long_drop, 1)
    wall, mono_wall = statistics.median(walls), statistics.median(mono_walls)
    with count_syncs() as syncs:
        again = long_drop()
    assert again.hexframes == res.hexframes, "two time-sharded decodes differ"
    log(f"[9d] 600 s int16 drop, decode_batch_timesharded on dp 1 x sp 4: status {res.status}, "
        f"serial {res.metadata['serial_no']}, probe {res.metadata['probe_code']}, max depth "
        f"{res.metadata['max_depth']}, overflow {res.overflow}, rows {len(res.time)}, frames "
        f"{len(res.hexframes)}, in truth {in_truth:.4f}, agreement with the monolithic decode "
        f"{agree_mono:.4f} (gate 0.99); tone_ratios launches {ts_launches}")
    log(f"[9d] first decode {first_s:.3f} s, warm wall (median of 3) {wall:.4f} s "
        f"{[round(w, 4) for w in walls]}, the WAV's read included, in turns with the "
        f"monolithic decode {mono_wall:.4f} s {[round(w, 4) for w in mono_walls]} "
        f"({wall / mono_wall:.2f}x; {mono['wall']:.4f} s in phase 3), realtime factor {600.0 / wall:.1f}x, peak device "
        f"memory {peak_gib:.2f} GiB, host syncs per decode {syncs['n']}")

    rows, bfs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]
    got = timeshard.decode_batch_timesharded(
        rows[:4], bfs, mesh=make_mesh({"dp": 2, "sp": 2}, [card] * 4))
    agrees = []
    for i, (r, ref) in enumerate(zip(got, bat["rows_8x8"])):
        assert r.status == 2 and r.overflow == 0, (i, r.status, r.overflow)
        assert r.metadata["serial_no"] == truth["serial_no"], i
        agrees.append(_agreement(r.hexframes, ref.hexframes))
    assert len(got) == 4 and min(agrees) >= 0.99, agrees
    log(f"[9d] 4 x 60 s int16 rows, decode_batch_timesharded on dp 2 x sp 2: every row status "
        f"2, serial = truth, overflow 0; hexframe agreement with decode_batch's rows "
        f"{[round(a, 4) for a in agrees]} (gate 0.99)")

    dp2 = make_mesh({"dp": 2}, [card] * 2)
    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    got = batch.decode_batch(rows[:16], bfs, mesh=dp2)
    dp_wall = time.perf_counter() - t0
    dp_launches = tonepower.tone_ratios.launches
    assert dp_launches == 2, f"{dp_launches} tone_ratios launches for 2 dp runs"
    _rows_equal(got, bat["rows_8x8"][:16], truth, "dp batch")
    log(f"[9d] 16 x 60 s rows, decode_batch(mesh=dp 2): every row equal to decode_batch's "
        f"(hexframes, metadata, time); tone_ratios launches {dp_launches} (one per dp run); "
        f"wall {dp_wall:.3f} s")

    batches = [(sub, None) for sub in np.split(rows, 8)[:2]]
    tonepower.tone_ratios.launches = 0
    t0 = time.perf_counter()
    out = pipeline.decode_batches_pipelined(batches, bfs, devices=[card, card])
    pipe_wall = time.perf_counter() - t0
    pipe_launches = tonepower.tone_ratios.launches
    assert pipe_launches == 2, f"{pipe_launches} tone_ratios launches for 2 pipelined batches"
    _rows_equal([r for b in out for r in b], piped["rows"][:16], truth, "two-device pipeline")
    log(f"[9d] 2 x 8 x 60 s, decode_batches_pipelined(devices=[cuda:0, cuda:0]): every row "
        f"equal to the one-device pipeline's; tone_ratios launches {pipe_launches} (one per "
        f"batch); wall {pipe_wall:.3f} s")
    return dict(timeshard_launches=ts_launches, dp_launches=dp_launches,
                pipe_launches=pipe_launches)


WIRES = ("int16", "int8", "int4")
DEV = "cuda"  # the device of the wire phase's tensors and decodes


def _h2d_ms(nbytes: int) -> float:
    """Median CUDA-event time of one pinned host-to-device copy of `nbytes`."""
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    host.to(DEV, non_blocking=True)
    return statistics.median(_event_ms(lambda: host.to(DEV, non_blocking=True))
                             for _ in range(5))


def _wire_tensors(raw: np.ndarray, rows: np.ndarray) -> None:
    """Item 1 of the wire phase: ``unpack_int4`` and ``condition_integer`` on
    the card against the CPU, on the host's encodings of the 600 s drop, of
    an odd length and of 8 archive rows."""
    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import wire as wire_ops

    def both(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t, t.to(DEV)

    n = len(raw)
    odd = raw[: 1_000_001]
    cases = [("600 s", wire_ops.encode(raw, "int4"), n),
             ("odd n", wire_ops.encode(odd, "int4"), len(odd)),
             ("8 rows", wire_ops.quantize_int4_packed_rows(rows[:8]), rows.shape[1])]
    for name, packed, width in cases:
        assert packed.dtype == np.uint8 and packed.shape[-1] == (width + 1) // 2, name
        cpu, card = both(packed)
        u_cpu, u_card = engine.unpack_int4(cpu, width), engine.unpack_int4(card, width)
        assert u_card.dtype == torch.int32 and u_card.shape[-1] == width, name
        assert torch.equal(u_card.cpu(), u_cpu), f"unpack_int4 differs on the card: {name}"
        assert int(u_cpu.abs().max()) <= 7, name
    q_cpu, q_card = both(wire_ops.quantize_int8_rows(rows[:8]))
    assert torch.equal(q_card.to(torch.int32).cpu(), q_cpu.to(torch.int32))
    seen = {}
    for w in ("int8", "int4"):
        cpu, card = both(wire_ops.encode(raw, w))
        if w == "int4":
            cpu, card = engine.unpack_int4(cpu, n), engine.unpack_int4(card, n)
        c_cpu = engine.condition_integer(cpu, n, torch.full((), n))
        c_card = engine.condition_integer(card, n, torch.full((), n, device=DEV))
        seen[w] = float((c_card.cpu() - c_cpu).abs().max())
        assert seen[w] <= 1e-6, (w, seen[w])
    log(f"[9e] unpack_int4 on the card bit-equal to the CPU: the 600 s drop ({n} samples), an "
        f"odd n ({len(odd)}), 8 archive rows (quantize_int4_packed_rows); quantize_int8_rows "
        f"as int32 equal; condition_integer card against CPU, max abs difference int8 "
        f"{seen['int8']:.3g}, int4 {seen['int4']:.3g} (tolerance 1e-6: the f32 sum's order "
        f"is the device's own)")


def _wire_long_drop(drops: dict, raw: np.ndarray, fs) -> dict:
    """Item 2: the 600 s WAV through ``decode_wav`` at every wire, monolithic
    and segmented.  Returns the decodes by (mode, wire).

    At int4 the quiet lead-in before the first pulse quantizes to the zero
    level, so the filtered signal there is a constant of about 1e-6 under
    the FFT's own rounding noise, whose sign flips are counted as
    crossings: where one 128-sample row collects more than the row cap of
    16, stage 1 drops the extra ones and raises bit 0 of ``overflow``.
    Whether a row does depends on the FFT's rounding (the card's and the
    CPU's differ).  That bit is reported and allowed at int4 and at no
    other wire; every other gate holds at every wire."""
    from axctdprocessor_tpu_torch.models import engine, segmented
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    wav, truth = drops["wav"], drops["truth"]
    item = {"int16": 2.0, "int8": 1.0, "int4": 0.5}
    _, _, seg_len, right, _ = segmented._seg_geometry(float(fs))
    seg_bytes = -(-len(raw) // seg_len) * (segmented.LEFT_HALO + seg_len + right)
    kept = {}
    for mode in ("monolithic", "segmented"):
        first = {}
        for w in WIRES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tonepower.tone_ratios.launches = 0
            res = engine.decode_wav(wav, device=DEV, wire=w, mode=mode)
            launches = tonepower.tone_ratios.launches
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            assert res.wire == w, (mode, w, res.wire)
            assert launches == (1 if mode == "monolithic" else 0), (mode, w, launches)
            in_truth = _gates(res, truth, allow_row_cap=w == "int4")
            agree = _agreement(res.hexframes, kept.get((mode, "int16"), res).hexframes)
            assert agree >= 0.99, (mode, w, agree)
            kept[mode, w] = res
            first[w] = (in_truth, agree, peak, launches)
        walls = {w: [] for w in WIRES}
        stages = {w: [] for w in WIRES}
        for _ in range(3):  # in turns: walls drift within a process
            for w in WIRES:
                timer = StageTimer()
                walls[w] += _walls(lambda: engine.decode_wav(
                    wav, device=DEV, wire=w, mode=mode, timer=timer), 1)
                stages[w].append(dict(timer.totals))
        for w in WIRES:
            in_truth, agree, peak, launches = first[w]
            nbytes = int((len(raw) if mode == "monolithic" else seg_bytes) * item[w])
            enc = [1e3 * (s.get("host_encode_stats", 0.0) + s.get("  encode_chunks", 0.0))
                   for s in stages[w]]
            up = [1e3 * (s.get("build_upload", 0.0) + s.get("  build_upload", 0.0))
                  for s in stages[w]]
            log(f"[9e] 600 s {mode} at wire {w}: status 2, serial, probe and max depth = truth, "
                f"overflow {kept[mode, w].overflow}, rows {len(kept[mode, w].time)}, frames "
                f"{len(kept[mode, w].hexframes)}, in truth {in_truth:.4f}, agreement with the "
                f"int16 decode {agree:.4f} (gate 0.99), res.wire {kept[mode, w].wire}, "
                f"tone_ratios launches {launches}; warm wall (median of 3, in turns) "
                f"{statistics.median(walls[w]):.4f} s {[round(x, 4) for x in walls[w]]}, host "
                f"encode {statistics.median(enc):.2f} ms {[round(x, 2) for x in enc]}, build + "
                f"pin + queue the upload {statistics.median(up):.2f} ms, H2D {nbytes} bytes "
                f"{_h2d_ms(nbytes):.3f} ms (one pinned copy of that size), peak device memory "
                f"{peak:.2f} GiB")
    return kept


def _wire_rows(tmp: str, drops: dict) -> list:
    """Item 3: the 64 noisy archive rows through ``decode_batch`` 8 x 8 at
    every wire with the int8 retry on, then at int4 through the pipeline and
    the archive runner.  Returns the indices of the rows the retry decoded
    again."""
    from scipy.io import wavfile

    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.parallel import batch, pipeline
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig, resolve_settings
    from axctdprocessor_tpu_torch.utils.report import write_report

    rows, fs, truth = drops["batch"], drops["batch_fs"], drops["batch_truth"]
    subs = np.split(rows, 8)
    cfg = DecoderConfig()
    out, runs = {}, {w: [] for w in WIRES}
    for w in WIRES:
        batch.decode_batch(subs[0], fs, device=DEV, wire=w)  # warm-up
    for turn in range(3):  # in turns: walls drift within a process
        for w in WIRES:
            if w == "int4" and turn:  # at over twice the wall, once tells enough
                continue
            torch.cuda.synchronize()
            tonepower.tone_ratios.launches = 0
            t0 = time.perf_counter()
            res = [r for sub in subs for r in batch.decode_batch(sub, fs, device=DEV, wire=w)]
            runs[w].append((time.perf_counter() - t0, tonepower.tone_ratios.launches, res))
    for w in WIRES:
        walls = [run[0] for run in runs[w]]
        wall, (_, launches, res) = statistics.median(walls), runs[w][0]
        assert all([r.wire for r in run[2]] == [r.wire for r in res] for run in runs[w]), w
        retried = [i for i, r in enumerate(res) if r.wire != w]
        for i, r in enumerate(res):
            allowed = ROW_CAP_BIT if r.wire == "int4" else 0  # see _wire_long_drop
            assert r.status == 2 and r.overflow & ~allowed == 0, (w, i, r.status, r.overflow)
            assert r.metadata["serial_no"] == truth["serial_no"], (w, i)
            assert r.wire == ("int8" if i in retried else w), (w, i, r.wire)
            assert not engine.lossy_retry_worthy(r, rows.shape[1], float(fs), cfg), (w, i)
        assert w == "int4" or not retried, (w, retried)
        redone_batches = len({i // 8 for i in retried})
        assert launches == 8 + redone_batches, (w, launches, redone_batches)
        agrees = [_agreement(r.hexframes, ref.hexframes)
                  for r, ref in zip(res, out.get("int16", (res,))[0])]
        assert statistics.mean(agrees) >= 0.99 and min(agrees) >= 0.97, (w, min(agrees))
        out[w] = (res, wall)
        log(f"[9e] 64 x 60 s noisy rows, decode_batch 8 x 8 at wire {w}, lossy_retry on: every "
            f"row status 2, serial = truth, rows with the row-cap bit of overflow "
            f"{sum(r.overflow != 0 for r in res)}, no other bit; rows decoded again at int8: "
            f"{len(retried)} {retried} (each comes back wire int8, in {redone_batches} batches); "
            f"tone_ratios launches {launches} (8 + one per batch with a retry); hexframe "
            f"agreement with the int16 rows mean {statistics.mean(agrees):.4f} min "
            f"{min(agrees):.4f} (gates 0.99 and 0.97); wall (median of {len(walls)}, in turns) "
            f"{wall:.3f} s {[round(x, 3) for x in walls]} ({64 * 60.0 / wall:.1f}x realtime)")
    want, _ = out["int4"]
    retried = [i for i, r in enumerate(want) if r.wire == "int8"]
    with count_syncs() as syncs:
        q_out, ctx = batch.dispatch_batch(subs[0], fs, device=DEV, wire="int4")
    first = batch.finish_dispatched(q_out, ctx)
    with count_syncs() as retry_syncs:
        batch.retry_lossy_rows(first, subs[0], fs, device=DEV)
    log(f"[9e] host syncs in dispatch_batch of 8 rows at int4: {syncs['n']}; in "
        f"retry_lossy_rows of that batch ({sum(i < 8 for i in retried)} rows decoded again): "
        f"{retry_syncs['n']}")
    assert syncs["n"] == 0, syncs["n"]

    def same(got, name):
        assert len(got) == len(want), name
        for i, (r, ref) in enumerate(zip(got, want)):
            assert (r.status, r.wire, r.overflow) == (ref.status, ref.wire, ref.overflow), (name, i)
            assert r.hexframes == ref.hexframes and r.metadata == ref.metadata, (name, i)
            assert r.time == ref.time, (name, i)

    t0 = time.perf_counter()
    piped = pipeline.decode_batches_pipelined([(sub, None) for sub in subs], fs, device=DEV,
                                              wire="int4")
    pipe_wall = time.perf_counter() - t0
    same([r for b in piped for r in b], "pipeline at int4")

    corpus = os.path.join(tmp, "corpus")  # the archive phase's WAVs, where it ran
    os.makedirs(corpus, exist_ok=True)
    paths = [os.path.join(corpus, f"row{i:02d}.wav") for i in range(len(rows))]
    for path, row in zip(paths, rows):
        if not os.path.exists(path):
            wavfile.write(path, int(fs), row)
    out_dir = os.path.join(tmp, "archive_out_int4")
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, out_dir, batch_size=8, device=DEV, wire="int4")
    corpus_wall = time.perf_counter() - t0
    rcfg = resolve_settings(None)
    echo = {"minR400": rcfg.min_r400, "mindR7500": rcfg.min_dr7500, "deadfreq": rcfg.dead_freq,
            "pointsperloop": 100000, "triggerrange": list(rcfg.trigger_range)}
    ref_txt = os.path.join(tmp, "want_int4.txt")
    for path, res in zip(paths, want):
        write_report(ref_txt, res, path, [0, -1], echo, rcfg)
        name = os.path.basename(path)
        got = os.path.join(out_dir, name[:-4] + ".txt")
        assert open(got, "rb").read() == open(ref_txt, "rb").read(), path
        entry = manifest["files"][name]
        assert entry["status"] == "done" and entry["wire"] == res.wire, (name, entry)
    log(f"[9e] the same rows at int4 through decode_batches_pipelined (wall {pipe_wall:.3f} s) "
        f"and reprocess_corpus(batch_size=8, wire=\"int4\") (wall {corpus_wall:.3f} s, "
        f"{len(rows) / corpus_wall:.2f} drops/s): rows (status, wire, hexframes, metadata, "
        f"time) and report bytes equal to decode_batch's at int4; the manifest records "
        f"{sum(v['wire'] == 'int8' for v in manifest['files'].values())} files as int8, the "
        f"rest as int4")
    return retried


def _wire_forced_retry(drops: dict, retried: list) -> int:
    """Item 4: one drop that collapses at int4 on the card through
    ``decode_waveform`` with and without the retry.  Returns the kernel's
    launch count of the retried decode."""
    from axctdprocessor_tpu_torch.models import engine, simulator
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    cfg = DecoderConfig()
    fs = drops["batch_fs"]

    def candidates():
        for i in retried[:2]:
            yield f"archive row {i} (60 s, seed 21, +-300 of noise)", drops["batch"][i]
        for seed, amp in ((11, 1.0), (11, 0.5), (3, 0.5), (5, 0.3), (7, 0.2)):
            spec = simulator.SimSpec(duration=60.0, profile_start=40.0, seed=seed, fsk_amp=amp)
            pcm, _ = simulator.synthesize(spec)
            yield (f"60 s drop of seed {seed}, profile at 40 s, fsk_amp {amp}",
                   np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16))

    for name, pcm in candidates():
        bare = engine.decode_waveform(pcm, fs, device=DEV, wire="int4", lossy_retry=False)
        assert bare.wire == "int4", bare.wire
        if not engine.lossy_retry_worthy(bare, len(pcm), float(fs), cfg):
            log(f"[9e] {name}: decodes at int4 on the card ({len(bare.hexframes)} frames), "
                f"not a collapse")
            continue
        tonepower.tone_ratios.launches = 0
        res = engine.decode_waveform(pcm, fs, device=DEV, wire="int4", lossy_retry=True)
        launches = tonepower.tone_ratios.launches
        assert res.wire == "int8" and res.status == 2, (res.wire, res.status)
        assert res.metadata["serial_no"] == "00123456", res.metadata["serial_no"]
        assert len(res.hexframes) > 4 * max(len(bare.hexframes), 1), \
            (len(res.hexframes), len(bare.hexframes))
        assert launches == 2, f"{launches} tone_ratios launches for a decode with one retry"
        seg = engine.decode_waveform(pcm, fs, device=DEV, wire="int4", mode="segmented")
        assert seg.status == 2 and seg.wire in ("int4", "int8"), (seg.status, seg.wire)
        log(f"[9e] forced retry, {name}: decode_waveform(wire=\"int4\", lossy_retry=False) "
            f"comes back wire int4, status {bare.status}, {len(bare.hexframes)} frames "
            f"(degenerate); with lossy_retry=True wire int8, status 2, {len(res.hexframes)} "
            f"frames, serial = truth; tone_ratios launches {launches} (the int4 decode and "
            f"its int8 retry); mode=\"segmented\" on the same drop comes back wire {seg.wire}, "
            f"{len(seg.hexframes)} frames (its retry decodes again segmented at int8)")
        return launches
    raise AssertionError("no candidate drop collapsed at the int4 wire on the card")


def _wire_cli(tmp: str, drops: dict, want) -> None:
    """Item 5: ``--wire int4`` through the CLI against the in-process decode
    (``"auto"`` mode: the segmented engine at 600 s)."""
    from axctdprocessor_tpu_torch.utils.config import resolve_settings
    from axctdprocessor_tpu_torch.utils.report import write_report

    wav = drops["wav"]
    out = os.path.join(tmp, "report_int4.txt")
    subprocess.run([sys.executable, "-m", "axctdprocessor_tpu_torch.cli", "-i", wav, "-o", out,
                    "--wire", "int4", "--quiet"], cwd=ROOT, check=True, timeout=600)
    settings = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5, "deadfreq": 3000.0,
                "pointsperloop": 100000, "mark_space_freqs": [400.0, 800.0],
                "use_bandpass": False}
    ref = os.path.join(tmp, "report_int4_want.txt")
    write_report(ref, want, wav, [0, -1], settings, resolve_settings(settings))
    assert open(out, "rb").read() == open(ref, "rb").read(), "CLI --wire int4 report differs"
    log(f"[9e] CLI subprocess with --wire int4 on the 600 s WAV: report bytes equal to "
        f"write_report of the in-process segmented decode at int4 "
        f"({open(out).read().count(chr(10))} lines)")


def phase9f_sosfilt(drops: dict) -> None:
    """The parallel (log-step scan) form of the SOS cascade on the card, on
    one second of the bench drop in float64: against the FFT form beyond
    the start-up transient, and against its own CPU run.  A check that the
    function runs and is right on the card; no decode path calls it."""
    from axctdprocessor_tpu_torch.ops import iir
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    x = raw[40 * fs: 41 * fs].astype(np.float64) / 32768.0
    sos = iir.design_sos(float(fs))
    card = torch.from_numpy(x).to(DEV)
    scan = iir.sosfilt(sos, card)
    via_fft = iir.sosfilt_fft(sos, card)
    assert scan.device.type == via_fft.device.type == torch.device(DEV).type
    np.testing.assert_allclose(scan.cpu().numpy()[3000:], via_fft.cpu().numpy()[3000:],
                               rtol=1e-6, atol=1e-8)
    on_cpu = iir.sosfilt(sos, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(scan.cpu().numpy(), on_cpu, rtol=1e-9, atol=1e-12)
    err = float(np.max(np.abs(scan.cpu().numpy()[3000:] - via_fft.cpu().numpy()[3000:])))
    log(f"[9f] iir.sosfilt (2x2 affine recurrence as a log-step scan, float64) on the card, "
        f"{len(x)} samples of the 600 s drop: equal to iir.sosfilt_fft beyond sample 3000 within "
        f"rtol 1e-6, atol 1e-8 (max abs difference {err:.3g}) and to its CPU run within rtol "
        f"1e-9, atol 1e-12")


def phase9e_wires(tmp: str, drops: dict) -> dict:
    """The lossy-wire paths on the card: int8, noise-shaped int4 and the int8
    retry through every entry point that takes ``wire=``.  A wire that fails
    a gate fails the run; nothing falls back to int16 or to the CPU."""
    from axctdprocessor_tpu_torch.utils.wavio import read_wav_raw16

    raw, fs = read_wav_raw16(drops["wav"])
    _wire_tensors(raw, drops["batch"])
    kept = _wire_long_drop(drops, raw, fs)
    retried = _wire_rows(tmp, drops)
    launches = _wire_forced_retry(drops, retried)
    _wire_cli(tmp, drops, kept["segmented", "int4"])
    return dict(retry_launches=launches, rows_retried=len(retried))


def main() -> int:
    smi, kind = phase0_device()
    phase1_build()
    mark("1 (builds)")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        drops = phase1_drops(tmp)
        if sys.argv[1:] == ["--only-wires"]:  # a development run: no result lines
            phase9e_wires(tmp, drops)
            phase9f_sosfilt(drops)
            return 3
        k = phase2_kernel(drops)
        mark("2")
        mono = phase3_end_to_end(drops)
        phase4_highrate(tmp)
        phase5_cli(tmp, drops["wav"])
        mark("3-5")
        seg = phase6_segmented(drops, mono)
        phase7_prestaged(drops, seg)
        phase8_stream(drops)
        mark("6-8")
        bat = phase9_batch(drops)
        piped = phase9a_pipeline(drops, bat)
        mark("9-9a")
        arch = phase9b_archive(tmp, drops, piped)
        mark("9b")
        phase9c_parity(tmp, drops, mono)
        mark("9c")
        multi = phase9d_multi_device(drops, mono, bat, piped)
        mark("9d")
        wires = phase9e_wires(tmp, drops)
        phase9f_sosfilt(drops)
        mark("9e-9f")
        phase10_profiles(drops, seg, k)
        mark("10")
    assert "jax" not in sys.modules, "the port loaded jax"
    loaded = [m for m in sys.modules
              if m == "axctdprocessor_tpu" or m.startswith("axctdprocessor_tpu.")]
    assert not loaded, f"the port loaded the JAX package: {loaded}"
    main_shape = k["shapes"][0]  # 600 s, the monolithic path's shape
    print(json.dumps({"kernels": [{
        "name": "tone_ratios", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": mono["launches"],
        "launches_per_decode_batch": bat["launches"],
        "launches_pipeline_8_batches": piped["launches"],
        "launches_archive_8_batches": arch["launches"],
        "launches_dp2_batch": multi["dp_launches"],
        "launches_two_device_pipeline_2_batches": multi["pipe_launches"],
        "launches_timeshard_decode": multi["timeshard_launches"],
        "launches_int4_decode_with_int8_retry": wires["retry_launches"],
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
