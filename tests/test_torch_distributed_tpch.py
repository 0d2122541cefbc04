"""TPC-H through the port's host stage walk at a small scale: the queries
of `chip_smoke.py` phase 13b (Q1, Q3, Q5, Q6, Q10, Q12, Q14) on
`tpch.data.generate(1 << 11)` (the tables of `benchmarks/tpch_mini.build`)
through a CPU Coordinator with 4 workers and a DistributedExecutor of 4
partitions, each query's Session-optimized logical plan:

* the rows equal the numpy oracle (`tpch/oracle.py`) and the JAX
  package's `DistributedExecutor` over the same plan, on a first and a
  warm run;
* the port's planner stages each query as the JAX planner does (none runs
  local), and the stage walk shuffles rows in each query with a join or
  a grouped aggregate;
* in `graphs` mode every executor of the walk admits nodes as on CUDA and
  its captures are stand-ins (tests/torch_graph_stand_in.py): a warm run
  replays or captures again over each fragment's new partition planes and
  still gives the oracle's rows.

Integers, strings and dates exactly, floats to rtol 1e-9.
"""

import pytest

from benchmarks import tpch_mini
from query_engine_tpu.parallel.coordinator import Coordinator as JCoordinator
from query_engine_tpu.parallel.dexecutor import (
    DistributedExecutor as JDistributedExecutor,
)
from query_engine_tpu.sql.parser import parse_sql as jparse
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.parallel.coordinator import Coordinator
from query_engine_tpu_torch.parallel.dexecutor import DistributedExecutor
from query_engine_tpu_torch.sql.parser import parse_sql
from query_engine_tpu_torch.tpch import data, oracle, queries

from torch_graph_stand_in import stand_in_graphs

N_LI = 1 << 11
STAGE_QUERIES = ("Q1", "Q3", "Q5", "Q6", "Q10", "Q12", "Q14")
NO_SHUFFLE = ("Q6",)  # a global aggregate over one table
WORKERS = 4


@pytest.fixture(scope="module")
def tables():
    return data.generate(N_LI)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX stage walk's rows and stage kinds for each query."""
    js, _ = tpch_mini.build(N_LI)
    c = JCoordinator()
    for i in range(WORKERS):
        c.register_worker(f"w{i}")
    dx = JDistributedExecutor(c)
    out = {}
    for q in STAGE_QUERIES:
        plan = js.optimizer.optimize(js.planner.create_logical_plan(
            jparse(queries.QUERIES[q])))
        out[q] = (dx.execute(plan, js.sources).to_pylist(),
                  [(s.kind, s.num_partitions)
                   for s in dx.planner.plan(plan).stages])
    return out


def _walk(tables, mode):
    s = Session(device="cpu")
    data.register(s, tables)
    c = Coordinator(device="cpu")
    for i in range(WORKERS):
        c.register_worker(f"w{i}")
    dx = DistributedExecutor(c)
    if mode == "graphs":
        stand_in_graphs(dx._local.pipeline)
        for w in c.active_workers():
            stand_in_graphs(c.runner(w.worker_id).executor.pipeline)
    return s, dx


@pytest.mark.parametrize("mode", ["compiled", "graphs"])
@pytest.mark.parametrize("q", STAGE_QUERIES)
def test_stage_walk_equals_oracle_and_jax(q, mode, tables, jax_side):
    s, dx = _walk(tables, mode)
    plan = s.optimizer.optimize(s.planner.create_logical_plan(
        parse_sql(queries.QUERIES[q])))
    dplan = dx.planner.plan(plan)
    assert not dplan.is_local
    jrows, jstages = jax_side[q]
    assert [(st.kind, st.num_partitions) for st in dplan.stages] == jstages
    want = oracle.run(q, tables)
    keys = oracle.FLOAT_SORT_KEYS.get(q, ())
    for _ in range(2):  # first, then warm
        shuffled = dx.stats.rows_shuffled
        rows = dx.execute(plan, s.sources).to_pylist()
        oracle.compare(rows, want, keys)
        oracle.compare(rows, jrows, keys)
        assert len(dx.last_stages) == len(dplan.stages)
        assert q in NO_SHUFFLE or dx.stats.rows_shuffled > shuffled
    assert dx.stats.task_failures == 0
