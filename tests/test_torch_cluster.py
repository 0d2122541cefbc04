"""Two-process torch.distributed test of the port's cluster bootstrap
(`query_engine_tpu_torch/parallel/cluster.py`), as tests/test_cluster.py
tests the JAX package's.

Spawns 2 CPU processes that join a gloo process group over a local
address (the one path a single-process virtual mesh cannot reach), run
the SPMD distributed aggregate, sort and join counts over the 2-process
mesh (one shard per rank; the all-to-alls, all-gathers and the outputs'
gathers are torch.distributed calls), and checks the gathered results
against directly computed oracles: test_cluster.py's for the aggregate.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.parallel import cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_cluster_child.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_aggregate_sort_join(tmp_path):
    port = _free_port()
    out_path = tmp_path / "result.json"
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
            env.pop(name, None)
        env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, str(port), str(pid), str(out_path)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=120)
            outs.append((p.returncode, stdout, stderr))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, stdout, stderr in outs:
        assert rc == 0, f"child failed rc={rc}\n{stderr[-3000:]}"
    got = json.loads(out_path.read_text())

    # oracle: same data generation as the child
    rng = np.random.default_rng(11)
    n = 4096
    k = rng.integers(0, 16, n)
    v = rng.integers(0, 1000, n)
    expected = {}
    for key in np.unique(k):
        mask = k == key
        expected[str(int(key))] = [int(mask.sum()), int(v[mask].sum())]
    assert got["groups"] == expected
    assert got["sort_overflow"] == 0
    assert got["sorted"] == sorted(v.tolist())
    counts = np.bincount(k)
    assert got["join_total"] == int((counts.astype(np.int64) ** 2).sum())
    assert got["roundtrip"] is True


def test_single_process_topology_and_mesh():
    """Without an address initialize reports this process alone; a CPU
    process's global mesh is one CPU shard; asking for the card without
    one raises instead of falling back."""
    try:
        info = cluster.initialize(device="cpu")
        assert (info.process_index, info.process_count) == (0, 1)
        assert info.is_controller
        mesh = cluster.global_mesh()
        assert [str(d) for d in mesh.devices] == ["cpu"]
        assert not mesh.process_group
    finally:
        cluster.shutdown()
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(DistributedError):
            cluster.initialize()


def test_address_without_world_size_raises(monkeypatch):
    monkeypatch.delenv("NUM_PROCESSES", raising=False)
    monkeypatch.delenv("PROCESS_ID", raising=False)
    with pytest.raises(DistributedError):
        cluster.initialize(coordinator_address="localhost:1", device="cpu")
    cluster.shutdown()
