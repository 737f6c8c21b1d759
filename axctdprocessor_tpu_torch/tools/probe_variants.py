"""Time the per-bit probe on one GPU: the checkout's ``probe.cu`` against an
earlier one in the same process, and the current design's run length and
span buffer.

The checkout's ``axctdprocessor_tpu_torch/ops/kernels/probe.cu`` is built as
``current``; ``--old PATH`` adds an earlier ``probe.cu`` with the same C
interface (``axctd_probe_launch``; e.g. the earlier design of one warp a probe, from
``git show bea2c77:axctdprocessor_tpu_torch/ops/kernels/probe.cu``), and
``--sweep`` the current source built at other run lengths and span buffers
(``-DAXCTD_PROBE_RUN``, ``-DAXCTD_PROBE_SPAN``).  Every build is compiled with
nvcc at once (a plain C interface, no PyTorch headers; ptxas's registers and
shared memory are printed) and loaded with ctypes.  The starts are those the
decodes hand ``goertzel.probe_at``, recorded as ``chip_smoke.py`` phase 2d
records them: the 600 s drop monolithic, segmented (groups of 4), prestaged
``fused``, time-sharded on dp 1 x sp 4 and streamed in 1 s float blocks, and
``decode_batch`` of 8 and of 64 archive rows.  At the first call of each path:

* every build held to ``tone_power_at`` (rtol = atol = 2e-4), and the current
  build bit-equal to the port's own binding of the same source;
* the builds and the library product (``frames @ trig`` of the gathered
  frames alone, ``chip_smoke._frontend_library``) timed in turns, the order
  reversed every other run: median over 10 runs of 5 calls of the CUDA-event
  ms per call, back to back and queued behind a sleep
  (``chain_variants.queued_ms``: the device's time without the host's gaps);
* then each one's device time from ``torch.profiler`` (mean of 10 calls),
  the bound (``chip_smoke._probe_bound``) and the share of it.

``--high-rate`` times, in place of the above, the extension's own geometries
(``probe_geometries()``, each forced) on the calls that ``decode_batch`` of 8
rows of 60 s at 88.2 and at 96 kHz makes at the native rate
(``chip_smoke._high_rate_probe_calls``): each bit-equal to the launcher's
geometry for the window, its share of staged runs, its times in turns with
``frames @ trig`` and its device time.

One JSON line per shape.  Needs one NVIDIA GPU; run as a file, from the
repository root:

    python axctdprocessor_tpu_torch/tools/probe_variants.py [--old PATH/probe.cu] [--sweep]
    python axctdprocessor_tpu_torch/tools/probe_variants.py --high-rate
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from axctdprocessor_tpu_torch.ops import goertzel  # noqa: E402
from axctdprocessor_tpu_torch.tools.chain_variants import _in_turns  # noqa: E402

BUILD = os.path.join(ROOT, "axctdprocessor_tpu_torch", "_build", "variants")
SOURCE = os.path.join(ROOT, cs.FRONTEND_SOURCE["probe_at"])
# (run, span floats); (64, 9216) is the launcher's geometry above a window of 50
SWEEP = [(64, 9216), (64, 5120), (256, 16384), (128, 16384), (512, 32768)]
P = ctypes.c_void_p
LL = ctypes.c_longlong
I = ctypes.c_int


def build(sources: dict) -> dict:
    """{name: (source, defines)} compiled at once with nvcc, each into its
    own library, loaded with ctypes."""
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for i, (name, (src, defines)) in enumerate(sources.items()):
        out = os.path.join(BUILD, f"libprobe_{i}.so")
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
        lib.axctd_probe_launch.argtypes = [P, LL, LL, I, P, LL, P, I, P, P]
        lib.axctd_probe_launch.restype = I
        libs[name] = lib
    return libs


def probe_call(lib, x, starts, trig):
    """This build's probe on the binding's arguments, as a function of
    nothing (its output made once)."""
    rows = x.shape[0] if x.dim() == 2 else 1
    ld = x.stride(0) if x.dim() == 2 and rows > 1 else x.shape[-1]
    st = starts.to(torch.int64).contiguous()
    tab = trig.to(torch.float32).contiguous()
    out = torch.empty(st.shape + (2,), dtype=torch.float32, device=x.device)

    def call():
        err = lib.axctd_probe_launch(x.data_ptr(), ld, x.shape[-1], rows, st.data_ptr(),
                                     st.shape[-1], tab.data_ptr(), tab.shape[0], out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe launch: CUDA error {err}")
        return out
    return call


def high_rate(smi: str) -> None:
    """The extension's geometries, each forced, at the 88.2 and 96 kHz batch
    calls: bits, staged share, times in turns, device times."""
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    geometries = [tuple(g) for g in ext.probe_geometries()]
    profiled = []
    for name, args in cs._high_rate_probe_calls():
        x, starts, window, trig = args
        want = goertzel.probe_at(*args)
        fns = {}
        for g in geometries:
            fns[f"{g[0]}x{g[1]}"] = (lambda g=g: ext.probe_at(x, starts, trig, *g))
            assert torch.equal(fns[f"{g[0]}x{g[1]}"](), want), (name, g)
        fns["library"] = cs._frontend_library("probe_at", args)
        bound_ms, bound_by = cs._probe_bound(x, starts, window)
        rec = dict(card=smi, shape=name, window=window, geometry=ext.probe_geometry(window),
                   staged_share={f"{g[0]}x{g[1]}": cs._probe_staged_share(x, starts, window, *g)[0]
                                 for g in geometries},
                   max_abs_err=cs._max_err([want], [goertzel.tone_power_at(*args)], name),
                   bound_ms=bound_ms, bound_by=bound_by, **_in_turns(fns))
        profiled.append((rec, fns))
    for rec, fns in profiled:  # the profiler last: it slows later launches
        rec["device_ms"] = {name: (cs._device_ms(fn, "probe_", calls=10) if name != "library"
                                   else cs._device_total_ms(fn))
                            for name, fn in fns.items()}
        rec["share_of_bound_device"] = {name: rec["bound_ms"] / ms
                                        for name, ms in rec["device_ms"].items() if ms}
        print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="an earlier probe.cu with the same C interface")
    ap.add_argument("--sweep", action="store_true", help="other run lengths and span buffers")
    ap.add_argument("--high-rate", action="store_true",
                    help="the extension's geometries at the 88.2 and 96 kHz batch calls")
    args = ap.parse_args()
    smi, _ = cs.phase0_device()
    if args.high_rate:
        high_rate(smi)
        return 0
    sources = {"current": (SOURCE, ())}
    if args.old:
        sources["old"] = (args.old, ())
    if args.sweep:
        for run, span in SWEEP:
            sources[f"run {run}, span {span}"] = (
                SOURCE, (f"AXCTD_PROBE_RUN={run}", f"AXCTD_PROBE_SPAN={span}"))
    libs = build(sources)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        calls = cs._record_frontend_calls(cs.phase1_drops(tmp))["probe_at"]
    profiled = []
    for _, path, shape, (x, starts, window, trig) in cs._frontend_timed({"probe_at": calls}):
        want = goertzel.tone_power_at(x, starts, window, trig)
        fns = {name: probe_call(lib, x, starts, trig) for name, lib in libs.items()}
        errs = {name: cs._max_err([fn()], [want], f"{path}: {name}") for name, fn in fns.items()}
        assert torch.equal(fns["current"](), goertzel.probe_at(x, starts, window, trig)), path
        fns["library"] = cs._frontend_library("probe_at", (x, starts, window, trig))
        bound_ms, bound_by = cs._probe_bound(x, starts, window)
        rec = dict(card=smi, shape=shape, max_abs_err=errs, bound_ms=bound_ms,
                   bound_by=bound_by, **_in_turns(fns))
        profiled.append((rec, fns))
    for rec, fns in profiled:  # the profiler last: it slows later launches
        rec["device_ms"] = {name: (cs._device_ms(fn, "probe_", calls=10) if name != "library"
                                   else cs._device_total_ms(fn))
                            for name, fn in fns.items()}
        rec["share_of_bound_device"] = {name: rec["bound_ms"] / ms
                                        for name, ms in rec["device_ms"].items() if ms}
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
