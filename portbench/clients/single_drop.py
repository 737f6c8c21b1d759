"""Single drops through ``decode_wav``, one client in a closed loop.

An operator decodes each drop's WAV as it lands: drops arrive minutes apart,
so nothing queues and a drop's time is its service time.  The client cycles
over a pool of drops: ``decode_wav(path, device=...)`` and then the port's
``utils/report.write_report`` into a report file of its own; a drop's
latency runs from the call to the report written.
"""

from __future__ import annotations

import os
import time

from portbench.core import inputs
from portbench.core.harness import Answer, Step


class Client:
    def __init__(self, config, traffic, seed, device, workdir, recorder):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.workdir, self.timer = device, workdir, recorder
        self.reports: list[Answer] = []
        self.checked: set[str] = set()  # inputs whose result is kept for the row check
        self.i = 0
        self.measuring = False
        from axctdprocessor_tpu_torch.models.engine import decode_wav
        from axctdprocessor_tpu_torch.utils.config import resolve_settings
        from axctdprocessor_tpu_torch.utils.report import write_report

        dec = config["decoder"]
        self.cfg = resolve_settings(dec.get("settings"), compat=dec["compat"])
        self.echo = {"minR400": self.cfg.min_r400, "mindR7500": self.cfg.min_dr7500,
                     "deadfreq": self.cfg.dead_freq, "pointsperloop": 100000,
                     "triggerrange": list(self.cfg.trigger_range)}
        self._decode, self._write = decode_wav, write_report
        self._kw = dict(wire=dec["wire"], mode=dec["mode"], compat=dec["compat"],
                        settings=dec.get("settings"))

    def make_inputs(self):
        specs = inputs.drop_specs(self.seed, inputs.drops_of(self.traffic))
        self.pool = inputs.render_all(specs, self.workdir)
        os.makedirs(os.path.join(self.workdir, "reports"), exist_ok=True)

    def _decode_one(self, drop: dict) -> Step:
        out = os.path.join(self.workdir, "reports", f"r{len(self.reports):05d}.txt")
        first = self.timer.mark()
        t0 = time.perf_counter()
        with self.timer.stage("decode_wav"):
            res = self._decode(drop["path"], device=self.device, timer=self.timer, **self._kw)
        with self.timer.stage("write_report"):
            self._write(out, res, drop["path"], [0, -1], self.echo, self.cfg)
        latency = time.perf_counter() - t0
        keep = self.measuring and drop["path"] not in self.checked
        if keep:
            self.checked.add(drop["path"])
        self.reports.append(Answer(drop["path"], out, res if keep else None, drop["path"],
                                   self.echo))
        return Step(latency_s=latency, audio_s=drop["seconds"],
                    spans=self.timer.totals_since(first), samples=drop["samples"],
                    fs=drop["fs"])

    def warm_up(self):
        for _ in range(int(self.traffic["warmup_rounds"])):
            for drop in self.pool:
                self._decode_one(drop)
        self.reports.clear()
        self.measuring = True

    def step(self) -> Step:
        drop = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self._decode_one(drop)

    def outputs(self):
        """Every report of the window and after; the first result of each
        drop of the pool is kept for the row check."""
        return self.reports

    def reference_jobs(self):
        return {d["path"]: {"path": d["path"], "name": d["path"]} for d in self.pool}

    def release(self):
        import gc

        gc.collect()
