"""Time versions of the tone-ratio kernel's source against each other on one GPU.

The checkout's ``axctdprocessor_tpu_torch/ops/kernels/tone_ratios.cu`` is built
as ``current``; each ``--source NAME=PATH`` adds another ``.cu`` with the same
plain C interface (an earlier version of the kernel, or an edited copy), and
each ``--shape WARPS,WPW`` the checkout's source with the ratios launched at
that block shape (warps per block, windows per warp; ``-DAXCTD_TONE_RATIOS_WARPS``,
``-DAXCTD_TONE_RATIOS_WPW``) in place of the standard (8, 16), as
``shape_WxP``; such a build must also give the standard build's outputs bit
for bit at every shape.  All are compiled with nvcc at once (no PyTorch
headers, so a build takes seconds) and loaded with ctypes; ptxas's register
and shared-memory report is printed.  Then, at every shape ``chip_smoke.py``
phase 2 holds the kernel to, each build is checked and timed with
chip_smoke's own helpers: against the plain version (rtol = atol = 2e-4,
equal NaN positions), each batch row bitwise equal to that build's 1-D call,
the median CUDA-event time per call in turns with the plain version, the time
of a ``clone`` of the input (the card's copy rate on the same bytes), and,
after every event time, the kernel's device time from ``torch.profiler``.
One JSON line per build and shape.  Needs one NVIDIA GPU:

    python scripts/tone_ratios_variants.py [--source old=PATH/tone_ratios.cu ...]
        [--shape 8,3 ...]
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from axctdprocessor_tpu_torch.ops import tonepower  # noqa: E402

BUILD = os.path.join(ROOT, "axctdprocessor_tpu_torch", "_build", "variants")


def build(sources: dict) -> dict:
    """{name: (path of a .cu, [-D defines])} compiled at once, loaded."""
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, (src, defines) in sources.items():
        out = os.path.join(BUILD, f"libtr_{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode=arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               *(f"-D{d}" for d in defines), "-o", out, src]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            print(text, flush=True)
            raise SystemExit(f"nvcc failed for {name}")
        cs.log(f"[build {name}] " + " | ".join(
            ln.strip() for ln in text.splitlines() if "registers" in ln or "spill" in ln))
        lib = ctypes.CDLL(out)
        lib.axctd_tone_ratios_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.axctd_tone_ratios_launch.restype = ctypes.c_int
        lib.axctd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.axctd_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def launcher(lib, tm, window: int, stride: int):
    """The build's kernel as a function of x, (n,) or (rows, n), like
    ``tonepower.tone_ratios``."""
    def call(x):
        n = x.shape[-1]
        n_win = tonepower.n_windows(n, window, stride)
        shape = x.shape[:-1] + (n_win,)
        r400 = torch.empty(shape, device=x.device)
        r7500 = torch.empty(shape, device=x.device)
        err = lib.axctd_tone_ratios_launch(
            x.data_ptr(), x.shape[0] if x.dim() == 2 else 1, n, tm.data_ptr(), window, stride,
            n_win, r400.data_ptr(), r7500.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(lib.axctd_cuda_error_string(err).decode())
        return r400, r7500
    return call


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--shape", action="append", default=[], metavar="WARPS,WPW")
    args = ap.parse_args()
    cs.phase0_device()  # exits without a GPU; TF32 off
    current = os.path.join(ROOT, cs.KERNEL_SOURCE)
    shapes = {}
    for text in args.shape:
        warps, wpw = (int(v) for v in text.split(","))
        shapes[f"shape_{warps}x{wpw}"] = (current, [f"AXCTD_TONE_RATIOS_WARPS={warps}",
                                                    f"AXCTD_TONE_RATIOS_WPW={wpw}"])
    libs = build({"current": (current, []), **shapes,
                  **{k: (v, []) for k, v in (s.split("=", 1) for s in args.source)}})
    runs = []
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        cases = cs._kernel_cases(cs.phase1_drops(tmp))
    for shape, xd, fs in cases:
        window, stride, tm = cs._table(fs)
        ref = tonepower.tone_ratios_reference(xd, tm, window, stride)
        rows = xd.shape[0] if xd.dim() == 2 else 1
        bound_ms, _ = cs._bound(rows, xd.shape[-1], window, ref[0].shape[-1])
        for name, lib in libs.items():
            call = launcher(lib, tm, window, stride)
            got = call(xd)
            if name in shapes:  # the same bits as the standard shape
                want = launcher(libs["current"], tm, window, stride)(xd)
                for g, w in zip(got, want):
                    assert torch.equal(torch.nan_to_num(g, nan=7.0),
                                       torch.nan_to_num(w, nan=7.0)), (shape, name)
            rec = dict(shape=shape, build=name, max_abs_err=cs._max_err(got, ref, name),
                       bound_us=1e3 * bound_ms)
            if xd.dim() == 2:
                cs._rows_bitwise(xd, got, call, f"{shape}, {name}")
            rec["ms"], rec["plain_ms"] = cs._time_pair(
                lambda: call(xd), lambda: tonepower.tone_ratios_reference(xd, tm, window, stride))
            rec["clone_ms"] = statistics.median(cs._event_ms(xd.clone, 10) for _ in range(5))
            runs.append((rec, call, xd))
    for rec, call, xd in runs:  # the profiler last: it slows later launches
        rec["device_ms"] = cs._device_ms(lambda: call(xd), "tone_ratios_kernel")
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
