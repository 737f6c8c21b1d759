"""run.py at its edges: no card, a cut run, a directory without the program,
where it writes, and one cell on the card (``-m cuda``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUN = os.path.join(ROOT, "portbench", "run.py")

# run.py's main with torch told there is one card (no card is used before
# harness.run, which the test replaces or lets fail)
FAKE_CARD = """
import os, signal, sys, time
root = sys.argv[1]
sys.path.insert(0, root)
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.get_device_name = lambda *a: "a card"
from portbench.core import harness
harness.memory_peak_bytes = lambda device: 0
if sys.argv[2] == "cut":
    def cut(*a, on_partial, **k):
        on_partial({"correct": True, "attempted": 3, "failed": 0,
                    "metrics": {"setup_s": {"value": 1.5, "unit": "s"}}})
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(60)
    harness.run = cut
sys.argv = [os.path.join(root, "portbench", "run.py"), "--workload", "drop600.auto",
            "--seed", "3", "--seconds", "1", "--trace", "0"]
import runpy
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_without_a_card_nothing_is_measured():
    p = subprocess.run([sys.executable, RUN, "--workload", "drop600.auto", "--seed",
                        str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "nothing measured" in p.stderr


def test_a_cut_run_still_prints_its_last_line(tmp_path):
    script = tmp_path / "fake_card.py"
    script.write_text(FAKE_CARD)
    p = subprocess.run([sys.executable, str(script), ROOT, "cut"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 143, p.stderr
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is False and line["attempted"] == 3
    assert line["metrics"]["setup_s"]["value"] == 1.5
    assert line["device"]["count"] == 1


def test_a_directory_without_the_program_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".scratch"))
    script = tmp_path / "fake_card.py"
    script.write_text(FAKE_CARD)
    p = subprocess.run([sys.executable, str(script), str(tmp_path), "whole"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "axctdprocessor_tpu_torch" in p.stderr


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, RUN, "--workload", "drop240.auto", "--seed",
                        str(2**32 + 7), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       env=_env(), capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"drop_rtf", "drop_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"
