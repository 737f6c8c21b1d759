"""One run of one cell: set-up, the measured window, the traced window, the
correctness check and the result's line.  Nothing here belongs to one cell:
the cell's client, traffic, limits and metrics are found by name
(``core/registry.py``).

A client (``clients/<name>.py``) has a class ``Client(config, traffic, seed,
device, workdir, recorder)`` with ``make_inputs()``, ``warm_up()``,
``step() -> Step`` (one unit of the window's work: a drop, a pass over a
corpus, a block of a live stream), ``outputs()`` (every answer due, as
``Answer``s), ``reference_jobs()`` (``{input key: job for
reference/job.decode}``, called after ``outputs()``) and ``release()``.
"""

from __future__ import annotations

import dataclasses
import sys
import time

from . import registry


@dataclasses.dataclass
class Step:
    """One unit of the window's work, timed on the host clock."""

    latency_s: float
    audio_s: float                 # audio seconds this unit completed
    spans: dict                    # the program's and the client's spans, seconds by name
    samples: float = 0.0           # true samples at the decode rate (the work's size)
    fs: float = 44100.0            # the decode rate
    batches: int = 0               # batches the unit ran (the archive runner)


@dataclasses.dataclass
class Answer:
    """One answer that was due: the report written for input `key` (None:
    it never came) and, where it is checked row by row, the decode result it
    was written from, the file name the report prints and the settings
    that its settings lines echo."""

    key: str
    report: str | None
    result: object = None
    name: str | None = None
    echo: dict | None = None
    streamed: list | None = None   # rows a live display received, in order


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads."""

    setup_s: float
    window_s: float                # the measured window, start to the end of its last unit
    steps: list                    # the window's Steps
    trace: object = None           # core.trace.Trace of the traced window, or None
    traced: list = dataclasses.field(default_factory=list)  # the traced window's Steps


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def measure_window(client, seconds: float) -> tuple[list, float]:
    """Units back to back until `seconds` have passed: every unit started
    in the window is finished and counted, and the window runs to its end."""
    steps, t0 = [], time.perf_counter()
    deadline = t0 + seconds
    while True:
        steps.append(client.step())
        now = time.perf_counter()
        if now >= deadline:
            return steps, now - t0


def traced_window(client, recorder, units: int, tries: int = 3):
    """`units` units under ``torch.profiler``; a profile in which the card
    recorded nothing is taken again (the profiler at times misses a short
    profile's device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace as tr

    result = (None, [])
    for _ in range(tries):
        recorder.profiling = True
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(tr.WINDOW_SPAN):
                    steps = [client.step() for _ in range(units)]
                    torch.cuda.synchronize()
        finally:
            recorder.profiling = False
        got = tr.from_profile(prof, units)
        result = (got, steps)
        if got is not None and got.device:
            break
    return result


def _read(path):
    if path is None:
        return None
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def judge(client, limits: dict, reference_runner) -> tuple[bool, dict, int, int]:
    """Every answer the run produced against the reference's decode of its
    input: (correct, numbers with limits, answers, answers failed).  An
    answer with its result is checked row by row; a report without its
    result has to be the same, byte for byte, as a report of the same input
    whose result was checked."""
    from . import judge as jd

    groups: dict[str, list] = {}
    for a in client.outputs():
        groups.setdefault(a.key, []).append(a)
    refs = reference_runner(client.reference_jobs())
    numbers = []
    for key, answers in groups.items():
        ref = refs[key]
        checked: dict[str, dict] = {}  # report text -> its numbers
        for a in sorted(answers, key=lambda a: a.result is None):
            text = _read(a.report)
            if text is None:
                numbers.append({"reports_missing": 1})
            elif a.result is not None:
                got = jd.compare(text, a.result, ref, a.name, a.echo)
                if a.streamed is not None:
                    got["streamed_wrong"] = jd.streamed_wrong(a.streamed, a.result)
                checked[text] = got
                numbers.append(got)
            elif text in checked:
                numbers.append(checked[text])
            else:
                numbers.append(dict(jd.compare(text, None, ref), reports_unstable=1))
    ok, table, failed = jd.verdict(numbers, limits)
    return ok, table, len(numbers), failed


def run_references(jobs: dict) -> dict:
    """The reference decodes, in parallel, in processes that load the frozen
    reference alone."""
    from ..reference.job import decode
    from .inputs import process_pool

    keys = list(jobs)
    with process_pool(len(keys)) as pool:
        return dict(zip(keys, pool.map(decode, [jobs[k] for k in keys])))


def read_metrics(bench: dict, workload: str, trace: bool, reading: Reading,
                 base: str = registry.HERE) -> dict:
    """Each metric of the run by its own reader; a reader that finds nothing
    to read returns None and its metric is left out."""
    out = {}
    for m in registry.metrics_of(bench, workload, trace):
        value = registry.metric(m["name"], base).read(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def memory_peak_bytes(device) -> int:
    import torch

    if torch.device(device).type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_start: float | None = None, traffic_override: dict | None = None,
        chips: int = 1, on_partial=None) -> dict:
    """One run of cell `workload`; returns the result's line as a dict
    (``checks``, the numbers compared beside their limits, last).
    ``on_partial(dict)`` is handed what is measured so far at each stage,
    for a run that is cut."""
    import shutil
    import tempfile

    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.benchmark()
    wl = registry.workload(bench, workload)
    config = registry.config(wl["config"])
    traffic = dict(registry.traffic(wl["traffic"]), **(traffic_override or {}))
    limits = registry.cell(workload)["limits"]
    from .spans import Recorder

    recorder = Recorder()
    workdir = tempfile.mkdtemp(prefix="portbench-")
    partial = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    on_partial = on_partial or (lambda d: None)
    try:
        client = registry.client(traffic["client"]).Client(config, traffic, seed, device,
                                                           workdir, recorder)
        log(f"{workload}: making the inputs from seed {seed}")
        client.make_inputs()
        log(f"{workload}: warming up at {time.perf_counter() - t_start:.1f} s")
        client.warm_up()
        setup_s = time.perf_counter() - t_start
        partial["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
        on_partial(partial)
        log(f"{workload}: set-up {setup_s:.3f} s; measuring {seconds} s")
        steps, window_s = measure_window(client, seconds)
        partial["attempted"] = len(steps)
        on_partial(partial)
        lat = sorted(s.latency_s for s in steps)
        log(f"{workload}: {len(steps)} units in {window_s:.3f} s; unit ms: min "
            f"{1e3 * lat[0]:.2f}, median {1e3 * lat[len(lat) // 2]:.2f}, max {1e3 * lat[-1]:.2f}")
        tr, traced = (None, [])
        if trace:
            tr, traced = traced_window(client, recorder, int(traffic["trace_units"]))
            log(f"{workload}: traced {len(traced)} units"
                + (f", device busy {tr.busy_s:.4f} of {tr.window_s:.4f} s" if tr else
                   ", no trace"))
        peak = memory_peak_bytes(device)
        client.release()
        reading = Reading(setup_s=setup_s, window_s=window_s, steps=steps, trace=tr,
                          traced=traced)
        metrics = read_metrics(bench, workload, trace, reading)
        partial["metrics"] = metrics
        on_partial(partial)
        log(f"{workload}: judging every answer against the reference")
        t_ref = time.perf_counter()
        ok, checks, answers, failed = judge(client, limits, run_references)
        log(f"{workload}: reference and comparison {time.perf_counter() - t_ref:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dev = {"platform": "gpu" if torch_device_type(device) == "cuda" else "cpu",
           "kind": device_name(device), "count": chips, "memory_peak_bytes": peak}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    line = {"correct": ok, "attempted": answers, "failed": failed, "metrics": metrics,
            "device": dev}
    if tr is not None:
        line["breakdown"] = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


def device_name(device) -> str:
    import torch

    if torch_device_type(device) == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"
