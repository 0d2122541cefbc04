"""The host stage walk on the card (`parallel/`), held against a CPU
Session on the same data and the TPC-H numpy oracle. Each test skips
without a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_distributed_cuda.py -m cuda

* `Coordinator()` and its workers' executors, and a DistributedExecutor
  over it, run on the card by default, and so do the batches of a result;
* `DistributedExecutor(mesh=object())` raises NotImplementedError;
* four workers run their fragments at once on the one card: in each
  stage their programs capture from four threads (one at a time under the
  pipeline's capture lock, in thread-local mode) while the other threads'
  fragments run, and each query equals the CPU Session's rows; then four
  threads capture and replay their own executors' programs at once;
* Q1, Q3 and Q6 through the stage walk equal the numpy oracle.
"""

import math
import threading

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.executor import _Materialized
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.parallel.coordinator import Coordinator
from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor
from query_engine_tpu_torch.parallel.partition import Partitioner
from query_engine_tpu_torch.plan.lowering import Lowering
from query_engine_tpu_torch.sql.parser import parse_sql
from query_engine_tpu_torch.tpch import data, oracle, queries

pytestmark = pytest.mark.cuda

RTOL = 1e-9
WORKERS = 4


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _table(n=200_000, seed=7):
    rng = np.random.default_rng(seed)
    t = {"k": rng.integers(0, 300, n).tolist(),
         "v": rng.integers(0, 1000, n).tolist(),
         "x": np.round(rng.normal(0, 50, n), 3).tolist(),
         "s": rng.choice(["ant", "bee", "cat"], n).tolist()}
    for i in range(0, n, 31):
        t["v"][i] = None
    return t


TABLE = _table()
SQLS = [
    "SELECT k, COUNT(*), SUM(v), AVG(x), MIN(v), MAX(x) FROM t WHERE v > 100 "
    "GROUP BY k",
    "SELECT s, COUNT(v), SUM(x) FROM t WHERE x > 0 GROUP BY s",
    "SELECT COUNT(*), SUM(v), AVG(x) FROM t WHERE k < 150",
]


def _same(got, want):
    key = lambda r: tuple((x is None, x if x is not None else 0)  # noqa: E731
                          for x in r)
    got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want), (got[:3], want[:3])
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0), (g, w)
            else:
                assert a == b, (g, w)


def _cluster(device=None):
    c = Coordinator() if device is None else Coordinator(device=device)
    for i in range(WORKERS):
        c.register_worker(f"worker{i}")
    return c


def _pipes(dx):
    return [dx.coordinator.runner(w.worker_id).executor.pipeline
            for w in dx.coordinator.active_workers()]


def test_coordinator_and_executor_default_to_the_card():
    c = _cluster()
    assert c.device.type == "cuda"
    for w in c.active_workers():
        assert c.runner(w.worker_id).executor.device.type == "cuda"
    s = Session()
    s.register_table("t", TABLE)
    dx = DistributedExecutor(c)
    assert dx.device.type == "cuda" and dx._local.device.type == "cuda"
    plan = s.optimizer.optimize(s.planner.create_logical_plan(
        parse_sql(SQLS[0])))
    out = dx.execute(plan, s.sources)
    assert all(col.data.is_cuda for col in out.columns)


def test_mesh_raises():
    """Named when the port had no mesh route; since the mesh pipeline
    `DistributedExecutor(mesh=...)` runs a plan that lowers as one program
    over 4 virtual shards of the card, with the CPU stage walk's rows."""
    from query_engine_tpu_torch.parallel.mesh import make_mesh

    s = Session()
    s.register_table("t", TABLE)
    cpu = Session(device="cpu")
    cpu.register_table("t", TABLE)
    dx = DistributedExecutor(_cluster(), mesh=make_mesh(["cuda:0"] * 4))
    for sql in SQLS:
        plan = s.optimizer.optimize(s.planner.create_logical_plan(
            parse_sql(sql)))
        out = dx.execute(plan, s.sources)
        assert all(col.data.is_cuda for col in out.columns)
        _same(out.to_pylist(), cpu.sql(sql).to_pylist())
        assert dx.last_stages == []
    st = dx._mesh_pipeline.stats
    assert st["compiles"] == len(SQLS) and st["fallbacks"] == 0, st


def test_four_workers_capture_at_once():
    cpu = Session(device="cpu")
    cpu.register_table("t", TABLE)
    s = Session(device="cuda")
    s.register_table("t", TABLE)
    dx = DistributedExecutor(_cluster())
    group_agg.launches = 0
    for sql in SQLS:
        plan = s.optimizer.optimize(s.planner.create_logical_plan(
            parse_sql(sql)))
        want = cpu.sql(sql).to_pylist()
        for _ in range(3):
            _same(dx.execute(plan, s.sources).to_pylist(), want)
        kinds = [k for _, k, _ in dx.last_stages]
        assert "partial_agg" in kinds and "final_agg" in kinds
    pipes = _pipes(dx)
    assert sum(p.stats["captures"] for p in pipes) >= WORKERS
    assert all(p.stats["captures"] > 0 for p in pipes)
    assert group_agg.launches > 0
    assert dx.stats.task_failures == 0


def test_four_threads_capture_and_replay_their_programs():
    """Each thread's executor captures and replays a grouped aggregate over
    its own partition, all four at once; every result equals the CPU's."""
    b = ColumnBatch.from_pydict(TABLE, device="cuda")
    parts = Partitioner.round_robin(WORKERS).partition(b)
    c = _cluster()
    runners = [c.runner(w.worker_id) for w in c.active_workers()]
    s = Session(device="cpu")
    s.register_table("t", TABLE)
    plan = Lowering(s.sources).lower(s.optimizer.optimize(
        s.planner.create_logical_plan(parse_sql(SQLS[0]))))

    def over(node, batch):
        # the plan with its scan replaced by the partition
        from dataclasses import replace

        if hasattr(node, "source"):
            return _Materialized(batch)
        return replace(node, input=over(node.input, batch))

    results, errors = {}, []
    barrier = threading.Barrier(WORKERS)

    def run(i):
        try:
            ex = runners[i].executor
            for rep in range(4):
                barrier.wait()
                results[(i, rep)] = ex.execute(
                    over(plan, parts[i])).to_pylist()
        except Exception as e:  # noqa: BLE001 reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors, errors
    for i, part in enumerate(parts):
        cpu = Session(device="cpu")
        cpu.register_table("t", part.to("cpu"))
        want = cpu.sql(SQLS[0]).to_pylist()
        for rep in range(4):
            _same(results[(i, rep)], want)
    for r in runners:
        st = r.executor.pipeline.stats
        assert st["captures"] >= 1 and st["replays"] >= 1


@pytest.mark.parametrize("q", ["Q1", "Q3", "Q6"])
def test_tpch_through_the_stage_walk(q):
    tables = data.generate(1 << 14)
    s = Session(device="cuda")
    data.register(s, tables)
    dx = DistributedExecutor(_cluster("cuda"))
    plan = s.optimizer.optimize(s.planner.create_logical_plan(
        parse_sql(queries.QUERIES[q])))
    want = oracle.run(q, tables)
    for _ in range(2):
        rows = dx.execute(plan, s.sources).to_pylist()
        oracle.compare(rows, want, oracle.FLOAT_SORT_KEYS.get(q, ()))
    assert len(dx.last_stages) > 1
