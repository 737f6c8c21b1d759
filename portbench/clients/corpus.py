"""An archive through ``reprocess_corpus``: passes over a corpus of WAVs,
one after another, each into an output directory of its own (``resume=False``,
so every pass decodes every file).  A unit is one pass: its latency is the
runner's wall, its audio every file it decoded.
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
        self.passes: list[str] = []
        from axctdprocessor_tpu_torch.parallel import archive

        self._run = archive.reprocess_corpus
        # the results of one pass, kept for the row check: the runner writes
        # each through this module's write_report, which is wrapped to keep them
        self.kept: dict[str, object] = {}
        self.keep = False
        write = archive.write_report

        def write_and_keep(path, res, wavfile, *a, **kw):
            write(path, res, wavfile, *a, **kw)
            if self.keep:
                self.kept[wavfile] = res

        archive.write_report = write_and_keep
        self._restore = lambda: setattr(archive, "write_report", write)
        dec = config["decoder"]
        from axctdprocessor_tpu_torch.utils.config import resolve_settings

        cfg = resolve_settings(dec.get("settings"), compat=dec["compat"])
        # the settings the runner's reports echo
        self.echo = {"minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500,
                     "deadfreq": cfg.dead_freq, "pointsperloop": 100000,
                     "triggerrange": list(cfg.trigger_range)}
        self._kw = dict(settings=dec.get("settings"), compat=dec["compat"], wire=dec["wire"],
                        batch_size=int(config["runner"]["batch_size"]))

    def make_inputs(self):
        specs = inputs.drop_specs(self.seed, inputs.drops_of(self.traffic))
        corpus = os.path.join(self.workdir, "corpus")
        os.makedirs(corpus)
        self.files = inputs.render_all(specs, corpus)
        self.paths = [f["path"] for f in self.files]
        self.audio_s = sum(f["seconds"] for f in self.files)
        # the runner decodes files above 50 kHz at half their rate (host decimation)
        self.samples = sum(f["seconds"] * (f["fs"] / 2 if f["fs"] > 50000 else f["fs"])
                           for f in self.files)

    def _pass(self) -> Step:
        out = os.path.join(self.workdir, f"pass{len(self.passes):04d}")
        first = self.timer.mark()
        t0 = time.perf_counter()
        with self.timer.stage("reprocess_corpus"):
            self._run(self.paths, out, device=self.device, resume=False, timer=self.timer,
                      **self._kw)
        latency = time.perf_counter() - t0
        self.passes.append(out)
        spans = self.timer.totals_since(first)
        batches = sum(1 for name, _, _ in self.timer.spans[first:]
                      if name == "device.dispatch_batch")
        return Step(latency_s=latency, audio_s=self.audio_s, spans=spans,
                    samples=self.samples, fs=44100.0, batches=batches)

    def warm_up(self):
        for _ in range(int(self.traffic["warmup_passes"])):
            self._pass()
        self.passes.clear()

    def step(self) -> Step:
        self.keep = not self.kept  # the window's first pass
        try:
            return self._pass()
        finally:
            self.keep = False

    def outputs(self):
        """Every report of every pass since the warm-up; the results of the
        window's first pass are kept for the row check."""
        out = []
        for i, d in enumerate(self.passes):
            for p in self.paths:
                rep = os.path.join(d, os.path.splitext(os.path.basename(p))[0] + ".txt")
                res = self.kept.get(p) if i == 0 else None
                out.append(Answer(p, rep if os.path.exists(rep) else None, res, p, self.echo))
        return out

    def reference_jobs(self):
        return {p: {"path": p, "name": p} for p in self.paths}

    def release(self):
        import gc

        self._restore()
        gc.collect()
