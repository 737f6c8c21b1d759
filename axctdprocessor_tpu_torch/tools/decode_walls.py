"""Warm walls of the port's decode paths, for the port of this checkout or of
another one, so that two trees can be compared in turns on one card.

The inputs are ``chip_smoke.py``'s, made by the tree under test: the 600 s
bench drop (``SimSpec(duration=600, profile_start=33, seed=11)`` as int16)
and the bench's 64 x 60 s archive batch (``chip_smoke.archive_batch()``);
besides, drops of 60 and 300 s (``SimSpec(duration=60, profile_start=40,
seed=21)``, the archive batch's drop, and ``SimSpec(duration=300,
profile_start=33, seed=11)``) and 8 rows of 60 s at 88.2 kHz (as
``chip_smoke._high_rate_probe_calls`` makes them).  The paths, as
``chip_smoke.py`` phases 3, 6, 7, 9 and 9b drive them:

* ``monolithic``: ``engine.decode_waveform(mode="monolithic")`` of the drop;
* ``monolithic 60 s``, ``monolithic 300 s``: the same of the shorter drops
  (the decode of every drop up to 300 s: one small-grid tone launch);
* ``segmented``: ``segmented.decode_waveform_segmented`` of the drop;
* ``prestaged``: ``prestage_waveform(wire="int8")`` once, then ``decode()``;
* ``batch 8 x 8``: the 64 rows through ``decode_batch`` as 8 batches of 8;
* ``pipeline 8 x 8``: the same 8 batches through ``decode_batches_pipelined``;
* ``stream snapshot``: one ``results()`` of a ``DeviceStreamDecoder`` pinned
  to the drop's length and fed all of it in 1 s float blocks;
* ``batch 8 x 60 s at 88.2 kHz``: the 8 rows through ``decode_batch`` at
  their native rate (the streamed tone table, the probe's high-rate geometry);
* ``corpus``: the 64 rows as int16 WAVs through ``reprocess_corpus(batch_size=8)``,
  into a new output directory each time (drops per second is 64 / wall).

The paths run as a user calls them: in a tree with cached programs
(``models/programs.py``) each path goes through the programs of its
shapes, whose first call runs eagerly and whose second captures a CUDA
graph, so that the timed decodes replay them (before that tree's cached
programs, the segmented, prestaged, stream and pipeline paths are eager).
``--eager`` runs every program's module eagerly over its static buffers
instead (the form ``chip_smoke._eager_programs`` times), so that both forms
of one tree can be timed in turns, one process each.

``--paths`` picks some of them (comma-separated names; all by default).
Each path is decoded twice to warm up, then ``--repeats`` times; the script
prints one JSON line with the card, the tree, and per path every wall and
their median, in seconds.  ``--tree`` names the root of another checkout (for
example an earlier commit's, unpacked with ``git archive``); run one tree per
process, as a file (not with ``-m``, which would import this checkout's port
first), and alternate the trees (earlier, this, this, earlier).  Needs one
NVIDIA GPU:

    python axctdprocessor_tpu_torch/tools/decode_walls.py [--tree DIR] [--repeats 5]
        [--paths monolithic,segmented] [--eager]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


HIGH = "batch 8 x 60 s at 88.2 kHz"
PATHS = ("monolithic", "monolithic 60 s", "monolithic 300 s", "segmented", "prestaged",
         "batch 8 x 8", "pipeline 8 x 8", "stream snapshot", "corpus", HIGH)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_walls: no GPU", file=sys.stderr)
        return 1
    from scipy.io import wavfile

    import chip_smoke
    from axctdprocessor_tpu_torch.models import engine, segmented, simulator
    from axctdprocessor_tpu_torch.parallel import batch, pipeline
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus

    if args.eager:
        from axctdprocessor_tpu_torch.models import programs

        programs.Program.capture = programs.Program.replay = programs.Program.run_eager

    def drop(duration: float, profile_start: float, seed: int, fs: float = 44100.0):
        pcm, _ = simulator.synthesize(simulator.SimSpec(duration=duration, fs=fs,
                                                        profile_start=profile_start, seed=seed))
        return np.round(pcm * (28000 / np.max(np.abs(pcm)))).astype(np.int16)

    names = args.paths.split(",")
    raw = drop(600.0, 33.0, 11)
    short = {s: drop(s, *spec) for s, spec in ((60.0, (40.0, 21)), (300.0, (33.0, 11)))
             if f"monolithic {s:g} s" in names}
    high = None
    if HIGH in names:  # as chip_smoke._high_rate_probe_calls makes them
        base = drop(60.0, 24.0, 5, 88200.0)
        rng = np.random.default_rng(88200)
        high = np.stack([np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
                         .astype(np.int16) for _ in range(8)])
    drops = chip_smoke.archive_batch()
    rows, fs_b = drops["batch"], drops["batch_fs"]
    staged = segmented.prestage_waveform(raw, 44100, device="cuda", wire="int8")
    stream = None
    if "stream snapshot" in names:
        from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

        pcm = raw.astype(np.float32) / 32768.0
        stream = DeviceStreamDecoder(44100, max_duration=600.0, device="cuda")
        for i in range(0, len(pcm), 44100):
            stream.feed(pcm[i: i + 44100])
    with tempfile.TemporaryDirectory(prefix=".decode_walls_", dir=tree) as tmp:
        paths = []
        for i, row in enumerate(rows):
            paths.append(os.path.join(tmp, f"row{i:02d}.wav"))
            wavfile.write(paths[-1], int(fs_b), row)
        outs = iter(range(1 << 30))

        def corpus():
            manifest = reprocess_corpus(paths, os.path.join(tmp, f"out{next(outs)}"),
                                        batch_size=8, device="cuda")
            assert all(v["status"] == "done" for v in manifest["files"].values()), manifest

        paths_run = {
            "monolithic": lambda: engine.decode_waveform(raw, 44100, device="cuda",
                                                         mode="monolithic"),
            "segmented": lambda: segmented.decode_waveform_segmented(raw, 44100, device="cuda"),
            **{f"monolithic {s:g} s": (lambda x=x: engine.decode_waveform(
                x, 44100, device="cuda", mode="monolithic")) for s, x in short.items()},
            "prestaged": staged.decode,
            "batch 8 x 8": lambda: [batch.decode_batch(sub, fs_b, device="cuda")
                                    for sub in np.split(rows, 8)],
            "pipeline 8 x 8": lambda: pipeline.decode_batches_pipelined(
                [(sub, None) for sub in np.split(rows, 8)], fs_b, device="cuda"),
            "stream snapshot": lambda: stream.results(),
            "corpus": corpus,
            HIGH: lambda: batch.decode_batch(high, 88200, device="cuda"),
        }
        walls = {}
        for name in names:
            run = paths_run[name]
            run()  # warm-up: the kernels' build, the plans
            run()  # the programs' captures
            torch.cuda.synchronize()
            walls[name] = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "tree": os.path.relpath(tree, os.getcwd()),
                      "form": "eager" if args.eager else "as called",
                      "median_s": {k: statistics.median(v) for k, v in walls.items()},
                      "walls_s": walls,
                      **({"corpus_drops_per_s": 64 / statistics.median(walls["corpus"])}
                         if "corpus" in walls else {})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
