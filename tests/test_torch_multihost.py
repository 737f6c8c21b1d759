"""The port's multi-host corpus sharding (``parallel.multihost``), on the CPU.

``init_distributed`` with no coordinator returns (0, 1) and starts no process
group; ``reprocess_corpus_multihost`` with one process writes into ``out_dir``
itself, the reports byte-equal to ``reprocess_corpus``'s, and passes ``mesh=``
on; with a count above one the host's share lands under ``out_dir/host<k>``.
One test starts two fresh interpreters that join a gloo group on a free local
port: ranks, world size, and two partitions that are disjoint and cover the
list.  (``partition_corpus`` against the JAX package's:
tests/test_torch_copies.py.)
"""

import ast
import glob
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from axctdprocessor_tpu_torch.models import simulator
from axctdprocessor_tpu_torch.parallel import multihost
from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_init_distributed_without_a_coordinator_touches_nothing():
    assert multihost.init_distributed() == (0, 1)
    assert multihost.init_distributed(None, 4, 2) == (0, 1)
    assert multihost.init_distributed("", 2, 1) == (0, 1)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    paths = []
    for i, seconds in enumerate((40.0, 38.0)):
        spec = simulator.SimSpec(duration=seconds, profile_start=33.0, seed=50 + i)
        paths.append(str(d / f"drop{i}.wav"))
        simulator.write_wav(paths[-1], simulator.synthesize(spec)[0], spec.fs)
    return paths


def _reports(out_dir):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(out_dir, "*.txt")))}


@pytest.fixture(scope="module")
def plain(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("plain"))
    reprocess_corpus(corpus, out, batch_size=2, device="cpu")
    return _reports(out)


def test_one_process_writes_into_out_dir_itself(corpus, plain, tmp_path):
    out = str(tmp_path / "single")
    manifest = multihost.reprocess_corpus_multihost(corpus, out, batch_size=2, device="cpu")
    assert sorted(os.listdir(out)) == ["drop0.txt", "drop1.txt", "manifest.json"]
    assert {e["status"] for e in manifest["files"].values()} == {"done"}
    assert _reports(out) == plain and len(plain) == 2
    assert not dist.is_initialized()


def test_mesh_goes_through_to_the_archive_runner(corpus, plain, tmp_path):
    out = str(tmp_path / "meshed")
    mesh = make_mesh({"dp": 2}, [torch.device("cpu")] * 2)
    multihost.reprocess_corpus_multihost(corpus, out, batch_size=2, mesh=mesh)
    assert _reports(out) == plain


def test_several_processes_write_under_their_host_directory(corpus, plain, tmp_path,
                                                            monkeypatch):
    """With the group's answer given (no group is started here): host 1 of 2
    decodes its share alone, into ``out_dir/host1``."""
    monkeypatch.setattr(multihost, "init_distributed", lambda *a: (1, 2))
    out = str(tmp_path / "two")
    manifest = multihost.reprocess_corpus_multihost(
        corpus, out, "127.0.0.1:1", 2, 1, batch_size=2, device="cpu")
    mine = multihost.partition_corpus(corpus, 1, 2)
    assert len(mine) == 1 and list(manifest["files"]) == [os.path.basename(mine[0])]
    assert os.listdir(out) == ["host1"]
    name = os.path.basename(mine[0])[:-4] + ".txt"
    assert _reports(os.path.join(out, "host1")) == {name: plain[name]}


_RANK_CHILD = """
import json, sys
from axctdprocessor_tpu_torch.parallel import multihost
coordinator, rank, paths = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
pid, count = multihost.init_distributed(coordinator, 2, rank)
import torch.distributed as dist
print("RANK " + json.dumps(dict(pid=pid, count=count, backend=dist.get_backend(),
                                mine=multihost.partition_corpus(paths, pid, count))))
dist.destroy_process_group()
assert "jax" not in sys.modules
"""


def test_two_processes_agree_on_ranks_and_partitions(tmp_path):
    """Two fresh interpreters join one gloo group over a free port of this
    machine.  One attempt, 60 s for both."""
    paths = []
    for i, size in enumerate((900, 100, 500, 300, 700)):
        paths.append(str(tmp_path / f"drop{i}.wav"))
        open(paths[-1], "wb").write(bytes(size))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    children = [subprocess.Popen(
        [sys.executable, "-c", _RANK_CHILD, f"127.0.0.1:{port}", str(rank)] + paths,
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in (0, 1)]
    said = []
    deadline = time.monotonic() + 60
    try:
        for child in children:
            out, err = child.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert child.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines() if ln.startswith("RANK "))
            said.append(json.loads(line[len("RANK "):]))
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=10)
    assert [r["pid"] for r in said] == [0, 1]
    assert [r["count"] for r in said] == [2, 2]
    assert {r["backend"] for r in said} == {"gloo"}
    a, b = (r["mine"] for r in said)
    assert not set(a) & set(b) and sorted(a + b) == sorted(paths)
    assert a == multihost.partition_corpus(paths, 0, 2)
    assert b == multihost.partition_corpus(paths, 1, 2)


def test_torch_distributed_is_imported_in_init_distributed_only():
    """No module of the port imports ``torch.distributed`` but
    ``parallel/multihost.py``, and that one only inside
    ``init_distributed``."""
    users = []
    for path in glob.glob(os.path.join(REPO, "axctdprocessor_tpu_torch", "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read(), filename=path)
        for fn in [tree] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            body = fn.body if fn is tree else list(ast.walk(fn))
            for node in body:
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                if any(n.startswith("torch.distributed") for n in names):
                    users.append((os.path.relpath(path, REPO), getattr(fn, "name", "<module>")))
    assert set(users) == {("axctdprocessor_tpu_torch/parallel/multihost.py",
                           "init_distributed")}, users
