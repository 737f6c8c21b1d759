"""Whether the tone-ratio kernel of this checkout gives the same bits as an
older version of its source, at every shape ``chip_smoke.py`` phase 2 holds
the kernel to (600 s, ragged, zero tail, 16 and 22.05 kHz, 3 rows, the lossy
wires' inputs, the archive rows as B = 8 and 64: all at rates whose table the
launcher holds resident).

Both sources are built with nvcc through ``scripts/tone_ratios_variants.py``'s
``build`` (the plain C entry ``axctd_tone_ratios_launch``, loaded with
ctypes); the checkout's extension (``tonepower.tone_ratios``) is held to the
same bits, and must report the resident table at each shape.  One JSON line
per shape.  Needs one NVIDIA GPU:

    python axctdprocessor_tpu_torch/tools/tone_ratios_same_bits.py --old OLD/tone_ratios.cu

(an older source, for example ``git show a4da911:axctdprocessor_tpu_torch/ops/
kernels/tone_ratios.cu`` into the git-ignored ``.chip_trees/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="an older tone_ratios.cu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from axctdprocessor_tpu_torch.ops import tonepower
    from axctdprocessor_tpu_torch.ops.kernels import extension

    spec = importlib.util.spec_from_file_location(
        "tone_ratios_variants", os.path.join(ROOT, "scripts", "tone_ratios_variants.py"))
    variants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(variants)
    cs.phase0_device()
    libs = variants.build({"current": (os.path.join(ROOT, cs.KERNEL_SOURCE), []),
                           "old": (os.path.abspath(args.old), [])})
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        cases = cs._kernel_cases(cs.phase1_drops(tmp))
    for shape, xd, fs in cases:
        window, stride, tm = cs._table(fs)
        rows = xd.shape[0] if xd.dim() == 2 else 1
        n_win = tonepower.n_windows(xd.shape[-1], window, stride)
        plan = extension().tone_plan(False, rows, n_win, window, stride)
        outs = {name: variants.launcher(lib, tm, window, stride)(xd) for name, lib in libs.items()}
        outs["extension"] = tonepower.tone_ratios(xd, tm, window, stride)
        same = {name: all(torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(o, nan=7.0))
                          for g, o in zip(got, outs["old"]))
                for name, got in outs.items() if name != "old"}
        print(json.dumps(dict(shape=shape, fs=fs, rows=rows, n_win=n_win, plan=plan,
                              same_bits_as_old=same)), flush=True)
        assert plan[0] == "resident" and all(same.values()), (shape, plan, same)
    return 0


if __name__ == "__main__":
    sys.exit(main())
