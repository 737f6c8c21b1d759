"""What the benchmark loads: nothing of JAX or the JAX package where it runs
the port, nothing of the port in its reference.  Module names are compared
by their whole top-level name (the port's name begins with the JAX
package's, so a prefix test would be wrong)."""

import ast
import json
import os
import subprocess
import sys

from portbench import run as run_py

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFERENCE = os.path.join(ROOT, "portbench", "reference")
JAX_NAMES = {"jax", "jaxlib", "flax", "axctdprocessor_tpu"}


def _top_level_modules(code: str) -> set:
    """Top-level names of every module a fresh interpreter holds after `code`."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    prog = code + ("\nimport sys, json\n"
                   "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_everything_run_py_imports_loads_no_jax():
    names = _top_level_modules(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.run\n"
        "from portbench.core import harness, judge, readers, registry, trace, inputs\n"
        "bench = registry.benchmark()\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    registry.metric(m['name'])\n"
        "for w in bench['workloads']:\n"
        "    registry.client(registry.traffic(w['traffic'])['client'])\n"
        # what the clients load when they are built
        "import axctdprocessor_tpu_torch.models.engine, axctdprocessor_tpu_torch.utils.report\n"
        "import axctdprocessor_tpu_torch.parallel.archive\n"
        "import axctdprocessor_tpu_torch.models.stream_device\n"
        "import portbench.reference.job\n")
    assert "axctdprocessor_tpu_torch" in names and "torch" in names
    assert not names & JAX_NAMES, names & JAX_NAMES


def test_reference_loads_nothing_of_the_port():
    names = _top_level_modules(
        "import sys; sys.path.insert(0, '.')\n"
        "import importlib, pkgutil\n"
        "import portbench.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('portbench.reference.' + m.name)\n"
        "import portbench.core.inputs\n")
    assert not names & (JAX_NAMES | {"axctdprocessor_tpu_torch", "torch"}), names


def test_reference_sources_import_only_numpy_scipy_and_the_standard_library():
    allowed = {"numpy", "scipy", "__future__", "dataclasses", "functools", "importlib",
               "math", "typing", "pickle", "os", "logging"}
    for name in sorted(os.listdir(REFERENCE)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REFERENCE, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = set() if node.level else {node.module.split(".")[0]}
            else:
                continue
            assert tops <= allowed, (name, tops)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "axctdprocessor_tpu_torch_fake", sys)
    assert run_py.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "axctdprocessor_tpu.models", sys)
    assert run_py.forbidden_modules() == ["axctdprocessor_tpu"]
