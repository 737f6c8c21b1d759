"""Count what one decode dispatches: PyTorch operations, and on a GPU the
host's launch calls and the device's kernels.

``--path`` picks the decode: ``monolithic`` (the default), ``segmented``
(``decode_waveform_segmented``), ``prestaged`` (``prestage_waveform`` once,
group by group, then ``decode()``), ``stream`` (one ``results()`` snapshot
of a ``DeviceStreamDecoder`` pinned to the drop's length and fed all of it
in 1 s float blocks) or ``pipeline`` (8 batches of 8 rows of the drop
through ``decode_batches_pipelined``; the counts are per run of 8 batches).

The decode runs on the card (``--device cuda``, the default, as every entry
point of the port; it raises without a GPU) or, with ``--device cpu``, on
the host.  The operations are those of the eager forward: they are counted
with ``TorchDispatchMode`` on a synthetic drop made by the simulator of the
tree under test (``SimSpec(duration=SECONDS, profile_start=33, seed=11)``,
int16), after one warm-up decode, with the decode's cached program
(``models/programs.py``, in a tree that has one) made to run its module
eagerly over its static buffers.  Besides the total it counts the
operations inside the bit-edge chain (``ops.chain.enumerate_bit_edges``)
and inside frame sync (``ops.chain.enumerate_frames``), and lists the most
frequent operations.  On the card the same decode then runs under
``torch.profiler``, in the eager form (``eager``) and, in a tree with cached
programs, through the program as the entry point runs it, a CUDA graph
captured at its second call and replayed after (``program``): per form the
kernel launches (``cudaLaunchKernel``, ``cuLaunchKernel``, as ``chip_smoke.py``
phase 10 counts them before PR 15), the host's launch calls (kernel and graph
launches, copies, fills) and the device's kernels.
``--plain-tone-ratios`` decodes with the plain tone-ratio version
(``use_kernel=False``), so that a tree's own kernel need not be built.
``--tree`` names the root of another checkout of the repository (for
example one unpacked with ``git archive``), whose port is imported instead
of this one's; run one tree per process, as a file (not with ``-m``, which
would import this checkout's port first).  One JSON line:

    python axctdprocessor_tpu_torch/tools/count_decode_ops.py [--tree DIR] [--seconds 60]
        [--device cpu] [--path segmented]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--plain-tone-ratios", action="store_true")
    ap.add_argument("--path", default="monolithic",
                    choices=("monolithic", "segmented", "prestaged", "stream", "pipeline"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from axctdprocessor_tpu_torch.models import engine, simulator
    from axctdprocessor_tpu_torch.ops import chain

    torch.set_num_threads(2)
    inside = {"total": 0, "enumerate_bit_edges": 0, "enumerate_frames": 0}
    names = collections.Counter()
    where = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            inside["total"] += 1
            names[str(func.overloadpacket.__name__)] += 1
            for w in set(where):
                inside[w] += 1
            return func(*args, **(kwargs or {}))

    def tagged(name, fn):
        def run(*a, **k):
            where.append(name)
            try:
                return fn(*a, **k)
            finally:
                where.pop()
        return run

    for name in ("enumerate_bit_edges", "enumerate_frames"):
        setattr(chain, name, tagged(name, getattr(chain, name)))
    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=args.seconds, profile_start=33.0,
                                                    seed=11))
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)

    def decode():
        return engine.decode_waveform(raw, 44100, device=args.device, mode="monolithic",
                                      use_kernel=not args.plain_tone_ratios)

    if args.path != "monolithic":
        from axctdprocessor_tpu_torch.models import segmented

        decode = {"segmented": lambda: segmented.decode_waveform_segmented(
            raw, 44100, device=args.device)}.get(args.path)
        if args.path == "prestaged":
            decode = segmented.prestage_waveform(raw, 44100, device=args.device).decode
        elif args.path == "stream":
            from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

            pcm32 = raw.astype(np.float32) / 32768.0
            stream = DeviceStreamDecoder(44100, max_duration=args.seconds, device=args.device)
            for i in range(0, len(pcm32), 44100):
                stream.feed(pcm32[i: i + 44100])
            decode = stream.results
        elif args.path == "pipeline":
            from axctdprocessor_tpu_torch.parallel import pipeline

            rows = np.stack([raw] * 8)

            def decode():
                return pipeline.decode_batches_pipelined([(rows, None)] * 8, 44100,
                                                         device=args.device)[0][0]

    try:
        from axctdprocessor_tpu_torch.models import programs
    except ImportError:  # a tree from before the cached programs: eager only
        programs = None

    @contextlib.contextmanager
    def eager():
        """The cached program, if any, runs its module eagerly."""
        if programs is None:
            yield
            return
        saved = programs.Program.capture, programs.Program.replay
        programs.Program.capture = programs.Program.replay = programs.Program.run_eager
        try:
            yield
        finally:
            programs.Program.capture, programs.Program.replay = saved

    decode()  # warm-up
    with eager(), Count():
        res = decode()
    out = dict(tree=os.path.abspath(args.tree), path=args.path, seconds=args.seconds,
               device=args.device,
               status=res.status, frames=len(res.hexframes), ops=inside,
               top=names.most_common(8))
    if args.device == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def profiled():
            decode()  # the program's capture, where it has none yet
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                decode()
                torch.cuda.synchronize()
            events = prof.events()
            host = collections.Counter()
            for e in events:
                if e.device_type != DeviceType.CPU:
                    continue
                if "GraphLaunch" in e.name:
                    host["graph launches"] += 1
                elif "Launch" in e.name and "Kernel" in e.name:
                    host["kernel launches"] += 1
                elif "Memcpy" in e.name or "Memset" in e.name:
                    host["copies and fills"] += 1
            return dict(launches=host["kernel launches"], host_launch_calls=sum(host.values()),
                        host=dict(host), device_kernels=sum(
                            e.device_type == DeviceType.CUDA
                            and not e.name.startswith(("Memcpy", "Memset")) for e in events))

        with eager():
            out["eager"] = profiled()
        out["launches"] = out["eager"]["launches"]
        if programs is not None:
            out["program"] = profiled()
        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
