"""Time the chain kernels on one GPU: the checkout's bit-edge segment walk
against an earlier ``chain.cu`` in the same process, and the walk's tiling;
with ``--frames``, frame sync's walk against the other ways to compute it.

The checkout's ``axctdprocessor_tpu_torch/ops/kernels/chain.cu`` is built as
``current``; ``--old PATH`` adds an earlier ``chain.cu`` with the level-table
kernels (``axctd_chain_compose_launch``, ``axctd_chain_walk_strided_launch``;
e.g. ``git show d6b032e:axctdprocessor_tpu_torch/ops/kernels/chain.cu``).  Both
are compiled with nvcc at once (plain C interfaces, no PyTorch headers; ptxas's
registers and shared memory are printed) and loaded with ctypes.  The
successor tables are those the decodes hand ``chain_enumerate_strided``,
recorded as ``chip_smoke.py`` phase 2b records them: the 600 s drop
monolithic, and ``decode_batch`` of 8 and of 64 archive rows.  At each one:

* every build held bit for bit to ``chain_enumerate_strided_reference``;
* the current walk and the old compose levels + strided walk timed in turns
  (old, new, new, old; median over 10 runs of 5 calls of the CUDA-event ms
  per call, back to back and queued behind a sleep, see ``queued_ms``), the
  old one with its level 0 made once beforehand, as its kernels alone, and
  as its whole function (level 0 included); then each one's device time
  from ``torch.profiler`` (the sum of its kernels per call), and the current
  walk's split over its three kernels; the device memory each whole function
  holds at its peak (the port's ``chain_enumerate_strided`` with its scratch;
  the old level tables);
* with ``--sweep``, the current walk at every segment size and segments per
  block of the grid below that fits in shared memory, each checked and
  timed queued.

With ``--frames`` the tables are frame sync's instead (``chain_enumerate_frames``'
recorded calls: the 600 s drop's profile frames and header windows, the batches
of 8 and 64 rows), and the versions, each held bit for bit to
``chain_enumerate_reference`` and timed in turns (CUDA events, back to back and
queued) and on device (profiler): ``chain_walk_frames`` at its tiling (its
binding, and the kernel alone with its flags' fill), the bit-edge walk's three
kernels instantiated at 32 entry states (``chain_segments_*<32>``, built with
``-DAXCTD_CHAIN_VARIANTS``), the jump tables + ``chain_walk`` (``chain_enumerate``),
and an empty kernel (the launch floor); with ``--sweep`` also
``chain_walk_frames`` at every warps x segments-per-warp tiling and the 32-state
segment walk at a few tilings, each checked and timed queued.

One JSON line per shape and build.  Needs one NVIDIA GPU; run as a file, from
the repository root:

    python axctdprocessor_tpu_torch/tools/chain_variants.py [--old PATH/chain.cu] [--sweep]
    python axctdprocessor_tpu_torch/tools/chain_variants.py --frames [--sweep]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from axctdprocessor_tpu_torch.ops import chain  # noqa: E402

BUILD = os.path.join(ROOT, "axctdprocessor_tpu_torch", "_build", "variants")
PATHS = ("600 s", "batch 8 x 60 s", "batch 64 x 60 s")
SWEEP = [(seg, tpb) for seg in (8, 16, 32, 64, 128) for tpb in (64, 128, 256, 512, 1024)]
FRAME_PATHS = ("600 s", "batch 8 x 60 s", "batch 64 x 60 s")
FRAME_SWEEP = [(w, spw) for w in (1, 2, 4, 8, 16, 32) for spw in (1, 2, 4, 8)]
SEG32_SWEEP = [(32, 32), (32, 64), (32, 128), (64, 32), (64, 64)]
P = ctypes.c_void_p
LL = ctypes.c_longlong
I = ctypes.c_int


def build(sources: dict, defines: tuple = ()) -> dict:
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        out = os.path.join(BUILD, f"libchain_{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *[f"-D{d}" for d in defines], "-o", out, src]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            print(text, flush=True)
            raise SystemExit(f"nvcc failed for {name}")
        lines = text.splitlines()
        for i, ln in enumerate(lines):  # "Compiling entry function 'X'", then its usage
            if "Compiling entry function" in ln:
                usage = [u.split(":", 1)[-1].strip() for u in lines[i + 1: i + 5]
                         if "registers" in u or "stack frame" in u]
                cs.log(f"[build {name}] {ln.split(chr(39))[1]}: {'; '.join(usage)}")
        lib = ctypes.CDLL(out)
        if hasattr(lib, "axctd_chain_segments_launch"):
            lib.axctd_chain_segments_scratch.argtypes = [I, LL, LL, LL, I, I, I]
            lib.axctd_chain_segments_scratch.restype = LL
            lib.axctd_chain_segments_launch.argtypes = [P, I, LL, LL, LL, I, I, I, P, P, P]
            lib.axctd_chain_segments_launch.restype = I
        if hasattr(lib, "axctd_chain_frames_launch"):
            lib.axctd_chain_frames_tiles.argtypes = [I, LL, LL, LL, I, I]
            lib.axctd_chain_frames_tiles.restype = LL
            lib.axctd_chain_frames_launch.argtypes = [P, I, LL, LL, LL, I, I, P, P, P, P]
            lib.axctd_chain_frames_launch.restype = I
        if hasattr(lib, "axctd_chain_compose_launch"):
            lib.axctd_chain_compose_launch.argtypes = [P, P, I, LL, I, I, P]
            lib.axctd_chain_compose_launch.restype = I
            lib.axctd_chain_walk_strided_launch.argtypes = [P, I, I, LL, I, LL, I, P, P]
            lib.axctd_chain_walk_strided_launch.restype = I
        libs[name] = lib
    return libs


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def segments_call(lib, nxt, k: int, seg: int, tpb: int, sb: int = 4):
    """The segment walk of this build at a tiling, as a function of nothing
    (its scratch and output made once)."""
    rows, m = nxt.shape
    nbytes = lib.axctd_chain_segments_scratch(rows, m, 0, k, sb, seg, tpb)
    if nbytes < 0:
        raise ValueError(f"the kernel does not take seg {seg}, tpb {tpb}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=nxt.device)
    out = torch.empty((rows, k), dtype=torch.int64, device=nxt.device)

    def call():
        _check(lib.axctd_chain_segments_launch(
            nxt.data_ptr(), rows, m, 0, k, sb, seg, tpb, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "chain_segments")
        return out
    return call


def frames_call(lib, succ, k: int, warps: int, spw: int):
    """This build's chain_walk_frames at a tiling (the flags zeroed before each
    launch, as the binding's torch.zeros does), as a function of nothing."""
    rows, m = succ.shape
    tiles = lib.axctd_chain_frames_tiles(rows, m, 0, k, warps, spw)
    if tiles < 0:
        raise ValueError(f"the kernel does not take {warps} warps x {spw}")
    flags = torch.zeros(tiles + 1, dtype=torch.int32, device=succ.device)
    recs = torch.empty(tiles * 66, dtype=torch.int32, device=succ.device)
    out = torch.empty((rows, k), dtype=torch.int64, device=succ.device)

    def call():
        flags.zero_()
        _check(lib.axctd_chain_frames_launch(
            succ.data_ptr(), rows, m, 0, k, warps, spw, flags.data_ptr(), recs.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream), "chain_frames")
        return out
    return call


def level_call(lib, nxt, k: int, with_level0: bool):
    """The old kernels: 7 compose levels (each from the one before) and the
    strided walk, over level tables made as ``delta_levels`` makes them; with
    `with_level0` the first level (``nxt - arange`` cast to int16) too."""
    rows, m = nxt.shape
    first = chain._first(k, 7)
    levels = torch.empty((chain._n_levels(k, first), rows, m), dtype=torch.int16,
                         device=nxt.device)
    ar = torch.arange(m, device=nxt.device)
    levels[0] = nxt - ar
    out = torch.empty((rows, k), dtype=torch.int64, device=nxt.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if with_level0:
            levels[0] = nxt - ar
        span, hi = 1, 4
        for j in range(1, levels.shape[0]):
            _check(lib.axctd_chain_compose_launch(levels[j - 1].data_ptr(), levels[j].data_ptr(),
                                                  rows, m, span, hi, stream), "compose")
            span, hi = 2 * span, 2 * hi
        _check(lib.axctd_chain_walk_strided_launch(levels.data_ptr(), levels.shape[0], rows, m, 0,
                                                   k, first, out.data_ptr(), stream), "walk")
        return out
    return call


def queued_ms(fn, calls: int = 5) -> float:
    """Device ms per call of `calls` back-to-back calls queued behind a 2 ms
    sleep on the stream, so that the host has issued every launch before the
    first runs: the CUDA-event time is the device's, without the host's gaps."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _in_turns(fns: dict, runs: int = 10, calls: int = 5) -> dict:
    """Median ms per call of each function, in turns (the order reversed every
    other run: a, b, ..., then ..., b, a): CUDA events around back-to-back
    calls ("ms", the host's gaps included) and the same queued behind a sleep
    ("queued_ms", the device's time)."""
    for fn in fns.values():
        fn()
        fn()
    ms = {name: [] for name in fns}
    queued = {name: [] for name in fns}
    names = list(fns)
    for i in range(runs):
        for name in (names if i % 2 == 0 else names[::-1]):
            ms[name].append(cs._event_ms(fns[name], calls))
            queued[name].append(queued_ms(fns[name], calls))
    return dict(ms={name: statistics.median(v) for name, v in ms.items()},
                queued_ms={name: statistics.median(v) for name, v in queued.items()})


def _peak_mb(fn) -> float:
    """MB of device memory that one call of `fn` holds at its peak, beyond
    what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e6


def _kernel_split(fn, calls: int = 10) -> dict:
    """Device ms per call of each of the segment walk's three kernels
    (``chip_smoke._device_ms``: from a profile that recorded every device
    event; None where none did)."""
    return {part: cs._device_ms(fn, f"chain_segments_{part}", calls)
            for part in ("records", "scan", "write")}


def frames_main(sweep: bool) -> int:
    """``--frames``: frame sync's walk, every version at each recorded shape."""
    smi, _ = cs.phase0_device()
    lib = build({"variants": os.path.join(ROOT, cs.CHAIN_SOURCE)},
                defines=("AXCTD_CHAIN_VARIANTS",))["variants"]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        calls = cs._record_chain_calls(cs.phase1_drops(tmp))["chain_walk_frames"]
    shapes = {}
    for path, (succ, start, k) in calls:
        succ = succ.reshape(-1, succ.shape[-1])
        if path in FRAME_PATHS and (path, succ.shape, k) not in shapes:
            shapes[path, succ.shape, k] = succ
    floor = statistics.median(queued_ms(cs._empty_kernel, 10) for _ in range(7))
    floor_device = cs._device_total_ms(cs._empty_kernel, calls=20)
    profiled = []
    for (path, (rows, m), k), succ in shapes.items():
        want = chain.chain_enumerate_reference(succ, 0, k)
        rec = dict(card=smi, shape=f"{path}: ({rows}, {m}) frame successors, k = {k}",
                   bound_us=1e3 * cs._chain_bound(rows, m, k), launch_floor_queued_ms=floor,
                   launch_floor_device_ms=floor_device,
                   tiling=f"{chain.FRAME_WARPS}x{chain.FRAME_SEGMENTS_PER_WARP}")
        fns = {"frames": lambda succ=succ, k=k: chain.chain_enumerate_frames(succ, 0, k),
               "frames kernel": frames_call(lib, succ, k, chain.FRAME_WARPS,
                                            chain.FRAME_SEGMENTS_PER_WARP),
               "segments<32>": segments_call(lib, succ, k, 32, 128, sb=32),
               "jump tables + chain_walk": lambda succ=succ, k=k: chain.chain_enumerate(succ, 0, k)}
        for name, fn in fns.items():
            assert torch.equal(fn(), want), f"{path}: {name} differs from the plain version"
        rec.update(_in_turns(fns))
        if sweep:
            grid = {}
            for w, spw in FRAME_SWEEP:
                fn = frames_call(lib, succ, k, w, spw)
                assert torch.equal(fn(), want), f"{path}: frames {w} x {spw} differs"
                grid[f"frames {w}x{spw}"] = statistics.median(queued_ms(fn) for _ in range(7))
            for seg, tpb in SEG32_SWEEP:
                if lib.axctd_chain_segments_scratch(rows, m, 0, k, 32, seg, tpb) < 0:
                    continue
                fn = segments_call(lib, succ, k, seg, tpb, sb=32)
                assert torch.equal(fn(), want), f"{path}: segments<32> {seg} x {tpb} differs"
                grid[f"segments<32> {seg}x{tpb}"] = statistics.median(
                    queued_ms(fn) for _ in range(7))
            rec["sweep_queued_ms"] = grid
        profiled.append((rec, fns))
    for rec, fns in profiled:  # the profiler last: it slows later launches
        rec["device_ms"] = {
            "frames kernel": cs._device_ms(fns["frames kernel"], "chain_frames_kernel", calls=10),
            "frames call": cs._device_total_ms(fns["frames"]),
            "segments<32>": cs._device_ms(fns["segments<32>"], "chain_segments_", calls=10),
            "jump tables + chain_walk": cs._device_total_ms(fns["jump tables + chain_walk"])}
        rec["share_of_bound_device"] = (rec["bound_us"] / 1e3 / rec["device_ms"]["frames kernel"]
                                        if rec["device_ms"]["frames kernel"] else None)
        print(json.dumps(rec), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier chain.cu with the level-table kernels")
    ap.add_argument("--sweep", action="store_true", help="time every tiling of the grid")
    ap.add_argument("--frames", action="store_true", help="frame sync's walk instead")
    args = ap.parse_args()
    if args.frames:
        return frames_main(args.sweep)
    smi, _ = cs.phase0_device()
    sources = {"current": os.path.join(ROOT, cs.CHAIN_SOURCE)}
    if args.old:
        sources["old"] = args.old
    libs = build(sources)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        calls = cs._record_chain_calls(cs.phase1_drops(tmp))["chain_walk_segments"]
    shapes = {}
    for path, (nxt, start, k) in calls:
        if path in PATHS and path not in shapes:
            shapes[path] = (nxt, k)
    profiled = []
    for path in PATHS:
        nxt, k = shapes[path]
        rows, m = nxt.shape
        want = chain.chain_enumerate_strided_reference(nxt, 0, k)
        rec = dict(card=smi, shape=f"{path}: ({rows}, {m}) int64 successors, k = {k}",
                   bound_us=1e3 * cs._chain_bound(rows, m, k))
        fns = {"new": segments_call(libs["current"], nxt, k, chain.SEGMENT,
                                    chain.SEGMENTS_PER_BLOCK)}
        if "old" in libs:
            fns["old kernels"] = level_call(libs["old"], nxt, k, with_level0=False)
            fns["old function"] = level_call(libs["old"], nxt, k, with_level0=True)
        for name, fn in fns.items():
            assert torch.equal(fn(), want), f"{path}: {name} differs from the plain version"
        rec.update(_in_turns(fns))
        rec["peak_mb"] = {"new": _peak_mb(lambda: chain.chain_enumerate_strided(nxt, 0, k))}
        if "old" in libs:  # its level tables, first level and output, made by the call
            rec["peak_mb"]["old function"] = _peak_mb(
                lambda: level_call(libs["old"], nxt, k, True)())
        rec["seg"], rec["tpb"] = chain.SEGMENT, chain.SEGMENTS_PER_BLOCK
        profiled.append((rec, fns))
        if args.sweep:
            sweep = {}
            for seg, tpb in SWEEP:
                if libs["current"].axctd_chain_segments_scratch(rows, m, 0, k, 4, seg, tpb) < 0:
                    continue  # a tile of more than 65,536 entries or shared memory
                fn = segments_call(libs["current"], nxt, k, seg, tpb)
                assert torch.equal(fn(), want), f"{path}: seg {seg}, tpb {tpb} differs"
                sweep[f"{seg}x{tpb}"] = statistics.median(queued_ms(fn) for _ in range(7))
            rec["sweep_queued_ms"] = sweep
    for rec, fns in profiled:  # the profiler last: it slows later launches
        rec["device_ms"] = {
            name: cs._device_ms(fn, "chain_segments_" if name == "new" else "chain_", calls=10)
            for name, fn in fns.items() if name != "old function"}
        rec["share_of_bound_queued"] = rec["bound_us"] / 1e3 / rec["queued_ms"]["new"]
        rec["device_split_ms"] = _kernel_split(fns["new"])
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
