"""The port's host-side distributed stage walk (`query_engine_tpu_torch/
parallel/`) against the JAX package's, on the same seeded inputs: every
case of tests/test_distributed.py but the mesh route (not in the port),
on CPU Coordinators and workers, plus

* partition ids bit-equal to JAX `spmd.partition_ids` and
  `Partitioner._hash_pids` over int64, negative, int32, float64, float32,
  NULL, dictionary-code (string) and two-column keys, with `splitmix64`'s
  bits;
* every partition of a hash, round-robin and range split holding the JAX
  package's rows in its order, and `route` giving its partition;
* `DistributedExecutor` results equal to the JAX `DistributedExecutor`'s
  and to the port's Session, with the stages the JAX planner plans;
* a task that fails once is retried on the pool, and partition p's result
  is partition p's whatever order the threads finish in;
* `DistributedExecutor(mesh=...)` raises NotImplementedError, and a
  Coordinator's default device is the card (RuntimeError without CUDA).

Integers exactly, floats to rtol 1e-9.
"""

import collections
import math
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.parallel import spmd as jspmd
from query_engine_tpu.parallel.coordinator import Coordinator as JCoordinator
from query_engine_tpu.parallel.dexecutor import (
    DistributedExecutor as JDistributedExecutor,
)
from query_engine_tpu.parallel.exchange import Merge as JMerge
from query_engine_tpu.parallel.partition import (
    Partitioner as JPartitioner, RangeBoundary as JRangeBoundary,
)
from query_engine_tpu.plan.planner import Planner as JPlanner
from query_engine_tpu.sql.parser import parse_sql as jparse
from query_engine_tpu.storage.memory import MemoryDataSource as JSource
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.parallel import spmd
from query_engine_tpu_torch.parallel.coordinator import Coordinator, Worker
from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor
from query_engine_tpu_torch.parallel.dplanner import (
    DistributedPlanner, ExchangeReason, QueryStage,
)
from query_engine_tpu_torch.parallel.exchange import (
    Exchange, Merge, ResultCollector,
)
from query_engine_tpu_torch.parallel.fault import (
    FaultConfig, FaultManager, TaskRecoveryAction, WorkerRecoveryAction,
)
from query_engine_tpu_torch.parallel.partition import (
    PartitionStrategy, Partitioner, RangeBoundary,
)
from query_engine_tpu_torch.parallel.scheduler import TaskScheduler
from query_engine_tpu_torch.parallel.types import QueryTask, WorkerInfo
from query_engine_tpu_torch.plan.planner import Planner
from query_engine_tpu_torch.sql.parser import parse_sql
from query_engine_tpu_torch.storage.memory import MemoryDataSource

RTOL = 1e-9


def make_data(n=100, keys=7, seed=5):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).tolist(),
            "v": rng.integers(0, 1000, n).tolist()}


def make_batch(n=100, keys=7):
    return ColumnBatch.from_pydict(make_data(n, keys))


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b and type(a) is type(b)


def same_rows(got, want, ordered=False):
    if not ordered:
        key = lambda r: tuple((x is None, str(type(x)), x if x is not None  # noqa: E731
                               else 0) for x in r)
        got, want = sorted(got, key=key), sorted(want, key=key)
    assert len(got) == len(want), (got[:3], want[:3])
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w)), \
            (g, w)


# ---- partition ids against the JAX package, bit for bit ---------------------
def _keys(kind, n=4000, seed=1):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.9
    if kind == "int64":
        data = rng.integers(-(2 ** 63), 2 ** 63 - 1, n, dtype=np.int64)
    elif kind == "negative":
        data = rng.integers(-50, 0, n)
    elif kind == "int32":
        data = rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32)
    elif kind == "float64":
        data = rng.normal(0, 1e6, n)
    elif kind == "float32":
        data = rng.normal(0, 1e3, n).astype(np.float32)
    elif kind == "null":
        data, valid = rng.integers(0, 9, n), np.zeros(n, dtype=bool)
    else:  # dictionary codes of a string column
        data = rng.integers(0, 40, n).astype(np.int32)
    return data, valid


KINDS = ["int64", "negative", "int32", "float64", "float32", "null", "codes"]


@pytest.mark.parametrize("n_parts", [1, 2, 3, 4, 7, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_partition_ids_bit_equal(kind, n_parts):
    data, valid = _keys(kind)
    want = np.asarray(jspmd.partition_ids(jnp.asarray(data),
                                          jnp.asarray(valid), n_parts))
    got = spmd.partition_ids(torch.from_numpy(data), torch.from_numpy(valid),
                             n_parts).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["int64", "negative", "codes"])
def test_splitmix64_bit_equal(kind):
    data, _ = _keys(kind)
    data = data.astype(np.int64)
    want = np.asarray(jspmd.splitmix64(jnp.asarray(data))).view(np.int64)
    assert np.array_equal(spmd.splitmix64(torch.from_numpy(data)).numpy(),
                          want)


def _pair_tables(n=3000, seed=2):
    rng = np.random.default_rng(seed)
    d = {"a": rng.integers(-20, 20, n).tolist(),
         "b": np.round(rng.normal(0, 50, n), 2).tolist(),
         "s": rng.choice(["x", "yy", "zzz", "w"], n).tolist(),
         "c": rng.integers(0, 1000, n).tolist()}
    for i in range(0, n, 17):
        d["a"][i] = None
    for i in range(0, n, 23):
        d["s"][i] = None
    return d


KEY_SETS = [["a"], ["b"], ["s"], ["a", "s"], ["b", "a"], ["c", "s", "a"]]


@pytest.mark.parametrize("keys", KEY_SETS, ids="+".join)
@pytest.mark.parametrize("n_parts", [3, 4])
def test_hash_pids_and_partitions_equal_jax(keys, n_parts):
    d = _pair_tables()
    jb, tb = JBatch.from_pydict(d), ColumnBatch.from_pydict(d)
    jp, tp = JPartitioner.hash(n_parts, keys), Partitioner.hash(n_parts, keys)
    want = np.asarray(jp._hash_pids(jb))
    got = tp._hash_pids(tb).numpy()
    assert np.array_equal(got, want)
    for jpart, tpart in zip(jp.partition(jb), tp.partition(tb)):
        assert tpart.num_rows == jpart.num_rows
        assert tpart.to_pydict() == jpart.to_pydict()


def test_round_robin_and_range_partitions_equal_jax():
    d = _pair_tables(500)
    jb, tb = JBatch.from_pydict(d), ColumnBatch.from_pydict(d)
    pairs = [(JPartitioner.round_robin(3), Partitioner.round_robin(3)),
             (JPartitioner.range(3, ["c"], [JRangeBoundary(300.0),
                                            JRangeBoundary(650.5)]),
              Partitioner.range(3, ["c"], [RangeBoundary(300.0),
                                           RangeBoundary(650.5)]))]
    for jp, tp in pairs:
        for jpart, tpart in zip(jp.partition(jb), tp.partition(tb)):
            assert tpart.to_pydict() == jpart.to_pydict()


def test_route_equals_jax():
    for n_parts in (3, 8):
        jp, tp = JPartitioner.hash(n_parts, ["k"]), Partitioner.hash(
            n_parts, ["k"])
        # Python's hash of a string differs between processes, not within
        for key in [0, 1, -5, 2 ** 40, "alpha", "beta", (1, 2)]:
            assert tp.route(key) == jp.route(key)
    jr = JPartitioner.range(3, ["v"], [JRangeBoundary(10.0),
                                       JRangeBoundary(20.0)])
    tr = Partitioner.range(3, ["v"], [RangeBoundary(10.0),
                                      RangeBoundary(20.0)])
    for key in [-1, 10, 15.5, 20, 99]:
        assert tr.route(key) == jr.route(key)
    assert Partitioner.single().route("x") == 0
    with pytest.raises(DistributedError):
        Partitioner.round_robin(2).route(1)


def test_padded_batch_partitions_live_rows_only():
    b = ColumnBatch.from_pydict({"k": list(range(130))})  # capacity 256
    parts = Partitioner.hash(4, ["k"]).partition(b)
    assert sum(p.num_rows for p in parts) == 130
    assert sorted(x for p in parts for x in p.to_pydict()["k"]) == list(
        range(130))
    for p in parts:
        ks = p.to_pydict()["k"]
        assert ks == sorted(ks)  # ascending row order within a partition


# ---- partitioner (reference partition.rs tests: row conservation) ----------
def test_hash_partition_row_conservation_and_colocation():
    b = make_batch(200)
    parts = Partitioner.hash(4, ["k"]).partition(b)
    assert sum(p.num_rows for p in parts) == 200
    # every key appears in exactly one partition
    seen = {}
    for i, p in enumerate(parts):
        for k in set(p.to_pydict()["k"]):
            assert seen.setdefault(k, i) == i


def test_round_robin_and_range_partition():
    b = make_batch(10)
    parts = Partitioner.round_robin(3).partition(b)
    assert [p.num_rows for p in parts] == [4, 3, 3]
    rp = Partitioner.range(
        2, ["v"], [RangeBoundary(500.0)]
    ).partition(b)
    assert sum(p.num_rows for p in rp) == 10
    assert all(v < 500 for v in rp[0].to_pydict()["v"])
    assert all(v >= 500 for v in rp[1].to_pydict()["v"])


def test_sorted_merge():
    b1 = ColumnBatch.from_pydict({"x": [5, 1, 9]})
    b2 = ColumnBatch.from_pydict({"x": [3, 7]})
    out = Merge.sorted([("x", True)]).execute([b1, b2])
    assert out.to_pydict()["x"] == [1, 3, 5, 7, 9]


def test_union_distinct_merge():
    b1 = ColumnBatch.from_pydict({"x": [1, 2, 2]})
    b2 = ColumnBatch.from_pydict({"x": [2, 3]})
    out = Merge.union_distinct().execute([b1, b2])
    assert sorted(out.to_pydict()["x"]) == [1, 2, 3]


@pytest.mark.parametrize("which", ["sorted", "union_distinct"])
def test_merges_equal_jax(which):
    d1, d2 = _pair_tables(300, 4), _pair_tables(200, 5)
    for d in (d1, d2):
        d["a"] = [None if x is None else x % 5 for x in d["a"]]
        d["c"] = [x % 3 for x in d["c"]]
    keep = ["a", "s", "c"]
    d1 = {k: d1[k] for k in keep}
    d2 = {k: d2[k] for k in keep}
    if which == "sorted":
        keys = [("a", False), ("s", True), ("c", True)]
        jm, tm = JMerge.sorted(keys), Merge.sorted(keys)
    else:
        jm, tm = JMerge.union_distinct(), Merge.union_distinct()
    want = jm.execute([JBatch.from_pydict(d1), JBatch.from_pydict(d2)])
    got = tm.execute([ColumnBatch.from_pydict(d1),
                      ColumnBatch.from_pydict(d2)])
    assert got.to_pylist() == want.to_pylist()


def test_result_collector():
    rc = ResultCollector(expected_partitions=2)
    rc.add_partition_result(0, [ColumnBatch.from_pydict({"x": [1]})])
    assert not rc.is_complete
    with pytest.raises(DistributedError):
        rc.finalize()
    rc.add_partition_result(1, [ColumnBatch.from_pydict({"x": [2]})])
    assert rc.finalize().to_pydict()["x"] == [1, 2]
    with pytest.raises(DistributedError):
        rc.add_partition_result(2, [])


def test_exchange_drops_empty_partitions():
    b = ColumnBatch.from_pydict({"k": [1, 1, 1]})
    out = Exchange.hash(4, ["k"]).execute([b, b])
    assert sum(len(p) for p in out) == 2
    assert sum(x.num_rows for p in out for x in p) == 6
    assert [len(p) for p in Exchange.gather().execute([b])] == [1]


# ---- coordinator / scheduler / fault (reference test shapes) ---------------
def test_coordinator_registry_and_health():
    c = Coordinator(device="cpu")
    w1 = c.register_worker("host1:50051")
    c.register_worker("host2:50051")
    with pytest.raises(DistributedError):
        c.register_worker("host1:50051")  # duplicate address
    assert c.active_worker_count() == 2
    # staleness sweep
    c._workers[w1].last_heartbeat_ms -= 1e6
    newly = c.check_worker_health()
    assert newly == [w1]
    assert c.active_worker_count() == 1
    c.heartbeat(w1)  # heartbeat revives
    assert c.active_worker_count() == 2
    st = c.cluster_status()
    assert st.total_workers == 2 and st.utilization == 0.0
    assert c.runner(w1).executor.device.type == "cpu"
    c.unregister_worker(w1)
    assert c.active_worker_count() == 1 and c.runner(w1) is None


def test_scheduler_fifo_and_least_loaded():
    s = TaskScheduler()
    t1 = QueryTask.new("q", 0, 0)
    t2 = QueryTask.new("q", 0, 1)
    s.submit(t1)
    s.submit(t2)
    assert s.get_next_task().task_id == t1.task_id
    workers = [
        WorkerInfo("a", "a:1", active_tasks=3),
        WorkerInfo("b", "b:1", active_tasks=1),
    ]
    assert s.choose_worker(workers).worker_id == "b"
    got = s.reschedule_failed(t1.task_id)
    assert got.retry_count == 1
    assert s.pending_count == 2


def test_fault_manager_retry_then_fail():
    fm = FaultManager(FaultConfig(max_task_retries=2))
    a1, d1 = fm.handle_task_failure("t1")
    a2, _ = fm.handle_task_failure("t1")
    a3, _ = fm.handle_task_failure("t1")
    assert a1 is TaskRecoveryAction.RETRY and d1 == 1.0
    assert a2 is TaskRecoveryAction.RETRY
    assert a3 is TaskRecoveryAction.FAIL
    # success resets
    fm.handle_task_success("t1")
    a4, _ = fm.handle_task_failure("t1")
    assert a4 is TaskRecoveryAction.RETRY


def test_fault_manager_worker_threshold_and_checkpoint():
    fm = FaultManager(FaultConfig(worker_failure_threshold=2))
    assert fm.handle_worker_failure("w") is WorkerRecoveryAction.NONE
    assert fm.handle_worker_failure("w") is WorkerRecoveryAction.MARK_UNHEALTHY
    fm.checkpoint_stage("q1", 0)
    fm.checkpoint_stage("q1", 1)
    plan = fm.recover_from_checkpoint("q1")
    assert plan.resume_from_stage == 2
    fm.clear_checkpoint("q1")
    assert fm.recover_from_checkpoint("q1") is None


def test_worker_drain_and_slots():
    w = Worker(max_tasks=1, device="cpu")
    assert w.execute_task(QueryTask.new("q", 0, 0, lambda: 7)).result == 7
    w.drain(0.1)
    assert not w.has_capacity()
    assert w.execute_task(QueryTask.new("q", 0, 0, lambda: 7)).status.name \
        == "CANCELLED"


# ---- distributed planner ---------------------------------------------------
def _logical(sql, tables):
    p = Planner()
    for name, schema in tables.items():
        p.register_table(name, schema)
    return p.create_logical_plan(parse_sql(sql))


def _jlogical(sql, tables):
    p = JPlanner()
    for name, schema in tables.items():
        p.register_table(name, schema)
    return p.create_logical_plan(jparse(sql))


def test_distributed_planner_aggregate_stages():
    b = make_batch(10)
    plan = _logical("SELECT k, SUM(v) FROM t GROUP BY k", {"t": b.schema})
    dp = DistributedPlanner(4)
    dplan = dp.plan(plan)
    assert not dplan.is_local
    kinds = [s.kind for s in dplan.stages]
    assert "partial_agg" in kinds and "final_agg" in kinds
    ex = dp.identify_exchanges(dplan.stages)
    assert any(e.reason is ExchangeReason.AGGREGATION for e in ex)


# ---- end-to-end distributed execution --------------------------------------
@pytest.fixture()
def cluster():
    c = Coordinator(device="cpu")
    for i in range(3):
        c.register_worker(f"host{i}:5005{i}")
    return c


def _jcluster():
    c = JCoordinator()
    for i in range(3):
        c.register_worker(f"host{i}:5005{i}")
    return c


SQL_CASES = {
    "aggregate": "SELECT k, COUNT(*), SUM(v), AVG(v), MIN(v), MAX(v) FROM t "
                 "GROUP BY k",
    "global": "SELECT COUNT(*), SUM(v), AVG(v), MAX(k) FROM t",
    "filter_sort": "SELECT v FROM t WHERE v > 500 ORDER BY v DESC",
    "non_decomposable": "SELECT k, COUNT(DISTINCT v), VAR_SAMP(v), "
                        "STDDEV_POP(v) FROM t GROUP BY k",
    "having_sort_limit": "SELECT k, SUM(v) AS s FROM t WHERE v < 900 GROUP BY "
                         "k HAVING COUNT(*) > 30 ORDER BY s DESC LIMIT 5",
}


@pytest.mark.parametrize("name", sorted(SQL_CASES))
def test_distributed_matches_jax_and_session(name, cluster):
    sql = SQL_CASES[name]
    d = make_data(500, keys=13)
    b = ColumnBatch.from_pydict(d)
    jb = JBatch.from_pydict(d)
    dex = DistributedExecutor(cluster)
    tplan = _logical(sql, {"t": b.schema})
    out = dex.execute(tplan, {"t": MemoryDataSource(batch=b, name="t")})
    jdex = JDistributedExecutor(_jcluster())
    jplan = _jlogical(sql, {"t": jb.schema})
    jout = jdex.execute(jplan, {"t": JSource(batch=jb, name="t")})
    s = Session(device="cpu")
    s.register_table("t", b)
    ordered = "ORDER BY" in sql
    same_rows(out.to_pylist(), jout.to_pylist(), ordered)
    same_rows(out.to_pylist(), s.sql(sql).to_pylist(), ordered)
    assert [(x.kind, x.num_partitions) for x in dex.planner.plan(
        tplan).stages] == [(x.kind, x.num_partitions)
                           for x in jdex.planner.plan(jplan).stages]
    assert dex.stats.tasks_executed > 0
    assert len(dex.last_stages) > 1
    assert dex.stats.rows_shuffled == jdex.stats.rows_shuffled


def test_distributed_aggregate_matches_local(cluster):
    b = make_batch(500, keys=13)
    sources = {"t": MemoryDataSource(batch=b, name="t")}
    sql = "SELECT k, COUNT(*), SUM(v), AVG(v), MIN(v), MAX(v) FROM t GROUP BY k"
    dex = DistributedExecutor(cluster)
    out = dex.execute(_logical(sql, {"t": b.schema}), sources)
    s = Session(device="cpu")
    s.register_table("t", b)
    same_rows(out.to_pylist(), s.sql(sql).to_pylist())
    assert dex.stats.tasks_executed > 0
    assert dex.stats.rows_shuffled > 0


def test_distributed_join_matches_local_and_jax(cluster):
    rng = np.random.default_rng(9)
    ld = {"k": rng.integers(0, 20, 300).tolist(), "lv": list(range(300))}
    rd = {"k": rng.integers(0, 20, 50).tolist(), "rv": list(range(50))}
    lb, rb = ColumnBatch.from_pydict(ld), ColumnBatch.from_pydict(rd)
    sources = {
        "l": MemoryDataSource(batch=lb, name="l"),
        "r": MemoryDataSource(batch=rb, name="r"),
    }
    schemas = {"l": lb.schema, "r": rb.schema}
    sql = "SELECT l.lv, r.rv FROM l JOIN r ON l.k = r.k"
    dex = DistributedExecutor(cluster)
    out = dex.execute(_logical(sql, schemas), sources)
    s = Session(device="cpu")
    s.register_table("l", lb)
    s.register_table("r", rb)
    same_rows(out.to_pylist(), s.sql(sql).to_pylist())
    jl, jr = JBatch.from_pydict(ld), JBatch.from_pydict(rd)
    jout = JDistributedExecutor(_jcluster()).execute(
        _jlogical(sql, {"l": jl.schema, "r": jr.schema}),
        {"l": JSource(batch=jl, name="l"), "r": JSource(batch=jr, name="r")})
    same_rows(out.to_pylist(), jout.to_pylist())
    assert dex.stats.rows_shuffled == 350


def test_distributed_filter_sort(cluster):
    b = make_batch(200)
    sources = {"t": MemoryDataSource(batch=b, name="t")}
    sql = "SELECT v FROM t WHERE v > 500 ORDER BY v DESC"
    out = DistributedExecutor(cluster).execute(
        _logical(sql, {"t": b.schema}), sources)
    vals = [r[0] for r in out.to_pylist()]
    assert vals == sorted([v for v in b.to_pydict()["v"] if v > 500],
                          reverse=True)


def test_distributed_non_decomposable_aggregates(cluster):
    """DISTINCT and VARIANCE/STDDEV aggregates have no per-partition
    partial — the planner emits a gather-then-aggregate-whole stage."""
    b = make_batch(500, keys=13)
    sources = {"t": MemoryDataSource(batch=b, name="t")}
    sql = ("SELECT k, COUNT(DISTINCT v), VAR_SAMP(v), STDDEV_POP(v) "
           "FROM t GROUP BY k")
    dex = DistributedExecutor(cluster)
    out = dex.execute(_logical(sql, {"t": b.schema}), sources).to_pylist()
    assert "single_agg" in [k for _, k, _ in dex.last_stages]
    s = Session(device="cpu")
    s.register_table("t", b)
    same_rows(out, s.sql(sql).to_pylist())


def test_failed_task_is_retried(cluster, monkeypatch):
    """A fragment that fails once is rescheduled and the query completes;
    the failure is counted."""
    b = make_batch(200)
    sources = {"t": MemoryDataSource(batch=b, name="t")}
    failed, lock = [], threading.Lock()
    for info in cluster.active_workers():
        runner = cluster.runner(info.worker_id)

        def flaky(task, real=runner.execute_plan_fragment):
            with lock:
                first = not failed
                failed.append(task.task_id)
            if first:
                raise RuntimeError("injected failure")
            return real(task)

        monkeypatch.setattr(runner, "execute_plan_fragment", flaky)
    sql = "SELECT k, SUM(v) FROM t GROUP BY k"
    dex = DistributedExecutor(cluster)
    out = dex.execute(_logical(sql, {"t": b.schema}), sources)
    s = Session(device="cpu")
    s.register_table("t", b)
    same_rows(out.to_pylist(), s.sql(sql).to_pylist())
    assert dex.stats.task_failures == 1
    assert dex.fault.stats.task_retries == 1


def test_worker_runs_one_fragment_at_a_time(monkeypatch):
    """Two stage walks at once on a coordinator with ONE worker: the
    worker takes both queries' tasks, and its executor (captures stood in
    on the CPU, tests/torch_graph_stand_in.py: a replay reads the planes
    it captured and overwrites its outputs, as a CUDA graph does) runs one
    fragment at a time, so each query still gets its own table's rows."""
    from torch_graph_stand_in import stand_in_graphs

    c = Coordinator(device="cpu")
    runner = c.runner(c.register_worker("host0:50050"))
    stand_in_graphs(runner.executor.pipeline)
    # the threads inside the executor (its execute recurses into itself)
    inside, state = collections.Counter(), {"most": 0}
    lock = threading.Lock()

    def watched(plan, real=runner.executor.execute):
        me = threading.get_ident()
        with lock:
            inside[me] += 1
            state["most"] = max(state["most"], len(inside))
        try:
            time.sleep(0.005)
            return real(plan)
        finally:
            with lock:
                inside[me] -= 1
                if not inside[me]:
                    del inside[me]

    monkeypatch.setattr(runner.executor, "execute", watched)
    sql = "SELECT k, SUM(v), COUNT(*) FROM t WHERE v > 100 GROUP BY k"
    batches = [ColumnBatch.from_pydict(make_data(400, 11, seed))
               for seed in (3, 4)]
    wants = []
    for b in batches:
        s = Session(device="cpu")
        s.register_table("t", b)
        wants.append(s.sql(sql).to_pylist())
    got, errors = [[], []], []

    def run(i):
        try:
            for _ in range(3):
                got[i].append(DistributedExecutor(c).execute(
                    _logical(sql, {"t": batches[i].schema}),
                    {"t": MemoryDataSource(batch=batches[i], name="t")},
                ).to_pylist())
        except Exception as e:  # noqa: BLE001 - reraised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert state["most"] == 1
    assert runner.executor.pipeline.stats["captures"] > 0
    for rows, want in zip(got, wants):
        assert len(rows) == 3
        for r in rows:
            same_rows(r, want)


def test_partition_results_stay_with_their_partition(cluster):
    """Partition p's result is partition p's, whichever thread ends first."""
    dex = DistributedExecutor(cluster)
    dex._queries["q"] = None
    stage = QueryStage(0, None, PartitionStrategy.SINGLE, 6)
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.02, 6)
    tasks = [(p, (lambda p=p: (time.sleep(delays[p]), p)[1]))
             for p in range(6)]
    assert dex._run_tasks("q", stage, tasks) == list(range(6))


def test_serialized_batch_roundtrip():
    """Arrow IPC round trip (reference network.rs:215-256 test shape)."""
    from query_engine_tpu_torch.parallel.network import (
        NetworkConfig, SerializedBatch,
    )

    b = make_batch(50)
    sb = SerializedBatch.serialize(b)
    assert sb.num_rows == 50 and sb.size_bytes > 0
    back = sb.deserialize()
    assert back.to_pydict() == b.to_pydict()
    with pytest.raises(DistributedError):
        SerializedBatch.serialize(b, NetworkConfig(max_message_bytes=10))


def test_flight_transport_fanout():
    pytest.importorskip("pyarrow.flight")
    from query_engine_tpu_torch.core.config import FlightConfig
    from query_engine_tpu_torch.flight.server import FlightServiceImpl
    from query_engine_tpu_torch.parallel.flight_transport import (
        FlightTransport,
    )

    servers = []
    transport = FlightTransport()
    for i in range(2):
        svc = FlightServiceImpl(FlightConfig(host="127.0.0.1", port=0),
                                Session(device="cpu"))
        svc.session.register_table(
            "t", ColumnBatch.from_pydict({"x": [i * 10, i * 10 + 1]})
        )
        threading.Thread(target=svc.serve, daemon=True).start()
        servers.append(svc)
        transport.add_worker(f"w{i}", f"grpc://127.0.0.1:{svc.port}")
    time.sleep(0.3)
    try:
        one = transport.execute_on_worker("w0", "SELECT SUM(x) FROM t")
        assert one.to_pylist() == [(1,)]
        results = transport.execute_on_all("SELECT SUM(x) FROM t")
        assert sorted(r.to_pylist()[0][0] for r in results) == [1, 21]
        transport.upload_to_worker("w1", "u", ColumnBatch.from_pydict(
            {"y": [4, 5]}))
        assert transport.execute_on_worker(
            "w1", "SELECT SUM(y) FROM u").to_pylist() == [(9,)]
        with pytest.raises(DistributedError):
            transport.execute_on_worker("nope", "SELECT 1")
        transport.remove_worker("w1")
        assert transport.workers() == ["w0"]
    finally:
        for svc in servers:
            svc.shutdown()


def test_checkpoint_disk_spill(tmp_path):
    fm = FaultManager(FaultConfig(checkpoint_dir=str(tmp_path)))
    b = make_batch(30)
    fm.checkpoint_stage("q9", 0, [b, b.slice(0, 5)])
    # stored as paths on disk
    cp = fm.get_checkpoint("q9")
    assert all(isinstance(p, str) for p in cp.intermediate[0])
    loaded = fm.load_checkpoint_data("q9", 0)
    assert loaded[0].to_pydict() == b.to_pydict()
    assert loaded[1].num_rows == 5
    assert fm.recover_from_checkpoint("q9").resume_from_stage == 1


def test_stage_walk_with_checkpoint_dir(cluster, tmp_path):
    """With checkpoint_dir set every stage's output spills as Arrow IPC;
    the result is unchanged and the checkpoint is cleared at the end."""
    b = make_batch(300, keys=9)
    sources = {"t": MemoryDataSource(batch=b, name="t")}
    sql = "SELECT k, COUNT(*), SUM(v) FROM t GROUP BY k"
    fm = FaultManager(FaultConfig(checkpoint_dir=str(tmp_path)))
    dex = DistributedExecutor(cluster, fault=fm)
    out = dex.execute(_logical(sql, {"t": b.schema}), sources)
    s = Session(device="cpu")
    s.register_table("t", b)
    same_rows(out.to_pylist(), s.sql(sql).to_pylist())
    assert list(tmp_path.rglob("*.arrow"))
    assert fm._checkpoints == {}


def test_mesh_is_not_in_the_port(cluster):
    """Named when the port had no mesh route; since the mesh pipeline
    (parallel/mesh_pipeline.py) `DistributedExecutor(mesh=...)` runs a
    plan that lowers as one program over the mesh, on its own executor
    of the coordinator's device, and takes no stage walk."""
    from query_engine_tpu_torch.parallel.mesh import make_mesh

    b = ColumnBatch.from_pydict({"k": [i % 5 for i in range(300)],
                                 "v": list(range(300))})
    sql = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    dex = DistributedExecutor(cluster, mesh=make_mesh(["cpu"] * 4))
    out = dex.execute(_logical(sql, {"t": b.schema}),
                      {"t": MemoryDataSource(batch=b, name="t")})
    s = Session(device="cpu")
    s.register_table("t", b)
    same_rows(out.to_pylist(), s.sql(sql).to_pylist())
    assert dex.last_stages == []
    mp = dex._mesh_pipeline
    assert mp.stats["compiles"] == 1 and mp.executor.device == cluster.device


def test_coordinator_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        c = Coordinator()
        assert c.device.type == "cuda"
        assert c.runner(c.register_worker("w")).executor.device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Coordinator()
        with pytest.raises(RuntimeError, match="CUDA"):
            Worker()
