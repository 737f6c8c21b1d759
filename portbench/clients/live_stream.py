"""A live receiver through ``DeviceStreamDecoder``: each drop's conditioned
audio fed as float32 blocks, one after another in a closed loop (the
upstream's loop takes 2.0 s of audio at a time and shows the new rows after
each).  A unit is one block: from ``feed(block)`` to ``latest_rows()``
returning, and for a drop's last block to ``finalize()`` returning.  Each
drop gets a new decoder; its constructor runs inside the window but outside
any block's time.

What the display receives is judged: the rows every ``latest_rows()`` call
returned, against the finished result's, and the snapshot that the call at
the middle of each drop assembled (``results()``), against the reference's
decode of the samples the snapshot covers.
"""

from __future__ import annotations

import os
import time

import numpy as np

from portbench.core import inputs
from portbench.core.harness import Answer, Step


class Client:
    def __init__(self, config, traffic, seed, device, workdir, recorder):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir, self.timer = device, workdir, recorder
        from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

        self._cls = DeviceStreamDecoder
        self.results: list[tuple[str, object, list]] = []  # (input, result, rows shown)
        self.snapshots: list[tuple[str, object]] = []      # (input, mid-drop snapshot)
        self.shown: list[dict] = []
        self.dec = None
        self.k = 0      # drops started
        self.pos = 0

    def make_inputs(self):
        from portbench.reference.wavio import read_wav

        specs = inputs.drop_specs(self.seed, inputs.drops_of(self.traffic))
        self.pool = inputs.render_all(specs, self.workdir)
        for d in self.pool:  # the receiver's conditioning, handed over as float32
            pcm, fs = read_wav(d["path"])
            d["x"], d["rate"] = pcm.astype(np.float32), fs
        self.block = int(round(float(self.traffic["block_s"]) * self.pool[0]["rate"]))

    def _new_decoder(self, drop):
        return self._cls(drop["rate"], max_duration=float(self.traffic["max_duration_s"]),
                         device=self.device)

    def warm_up(self):
        drop = self.pool[0]
        dec = self._new_decoder(drop)
        for b in range(int(self.traffic["warmup_blocks"])):
            dec.feed(drop["x"][b * self.block:(b + 1) * self.block])
            dec.latest_rows()
        dec.finalize()
        dec.latest_rows()

    def _keep_snapshot(self):
        """Make the decoder's next ``results()`` keep its snapshot."""
        kept, snapshot = self.snapshots, self.dec.results
        path = self.pool[self.k % len(self.pool)]["path"]

        def results():
            res = snapshot()
            if res.numpoints:  # a snapshot of no segment shows nothing
                kept.append((path, res))
            return res

        self.dec.results = results

    def step(self) -> Step:
        drop = self.pool[self.k % len(self.pool)]
        if self.dec is None:
            self.dec, self.pos, self.shown = self._new_decoder(drop), 0, []
        block = drop["x"][self.pos:self.pos + self.block]
        half = len(drop["x"]) // 2
        mid = self.pos < half <= self.pos + len(block)
        self.pos += len(block)
        last = self.pos >= len(drop["x"])
        if mid and not last:
            self._keep_snapshot()
        first = self.timer.mark()
        t0 = time.perf_counter()
        with self.timer.stage("feed"):
            self.dec.feed(block)
        if last:
            with self.timer.stage("finalize"):
                res = self.dec.finalize()
        else:
            with self.timer.stage("latest_rows"):
                rows = self.dec.latest_rows()
        latency = time.perf_counter() - t0
        if last:
            self.results.append((drop["path"], res, self.shown))
            self.dec, self.k = None, self.k + 1
        else:
            self.shown.extend(rows)
            if mid:
                del self.dec.results
        return Step(latency_s=latency, audio_s=len(block) / drop["rate"],
                    spans=self.timer.totals_since(first), samples=len(block),
                    fs=drop["rate"])

    def _write(self, res, path: str, i: int, tag: str) -> str:
        from portbench.reference.job import report_of

        rep = os.path.join(self.workdir, f"{tag}{i:03d}.txt")
        with open(rep, "w") as f:
            f.write(report_of(res, path))
        return rep

    def outputs(self):
        """Each finished drop's result, with the rows shown live, and each
        mid-drop snapshot, written in the report's format by the frozen
        writer (the stream itself writes no report)."""
        out = [Answer(path, self._write(res, path, i, "stream"), res, path,
                      streamed=shown)
               for i, (path, res, shown) in enumerate(self.results)]
        out += [Answer(self._snapshot_key(path, res), self._write(res, path, i, "snapshot"),
                       res, path) for i, (path, res) in enumerate(self.snapshots)]
        return out

    @staticmethod
    def _snapshot_key(path: str, res) -> str:
        return f"{path}#{res.numpoints}"

    def reference_jobs(self):
        jobs = {d["path"]: {"path": d["path"], "name": d["path"], "samples": "float32"}
                for d in self.pool}
        for path, res in self.snapshots:
            jobs[self._snapshot_key(path, res)] = dict(jobs[path], n_samples=res.numpoints)
        return jobs

    def release(self):
        import gc

        self.dec = None
        gc.collect()
