"""Find a cell's files by name: nothing here names one cell.

* ``BENCHMARK.json`` (the repository root): the cells, their configuration,
  traffic and chips, and the metrics with the cells they are read in;
* ``configs/<config>.json``: the deployment (decoder settings, input format);
* ``traffic/<traffic>.json``: the traffic mix, the parameters the general
  generator (``core/inputs.py``) and the mix's client read;
* ``clients/<client>.py``: the client of one entry point of the port;
* ``cells/<workload>.json``: the limits of the cell's correctness check;
* ``metrics/<metric>.py``: one metric's reader, ``read(reading)``.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "configs", name + ".json"))


def traffic(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "traffic", name + ".json"))


def cell(name: str, base: str = HERE) -> dict:
    return _json(os.path.join(base, "cells", name + ".json"))


def _load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def client(name: str, base: str = HERE):
    return _load(os.path.join(base, "clients", name + ".py"), "portbench_client_" + name)


def metric(name: str, base: str = HERE):
    """The reader module of metric `name` (a name may hold dots)."""
    mod = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    return _load(os.path.join(base, "metrics", name + ".py"), mod)


def metrics_of(bench: dict, workload_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell prints: its end-to-end metrics without
    a trace, its per-layer metrics with one; a metric with a ``workloads``
    key only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload_name in m.get("workloads", [workload_name])]
