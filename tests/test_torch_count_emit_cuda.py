"""The count->emit programs, bounded-duplication, outer and residual-outer
joins and group-space counting on the card: `tpch/count_emit.py`'s
queries at `data.generate(1 << 14)` through `Session("cuda")`, held
against the numpy oracle and the CPU Session. Each test skips without a
CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_count_emit_cuda.py -m cuda

* every query's first run (count program and emit program run eagerly,
  then captured) and two warm runs (both replayed, no new capture) equal
  the oracle; J1-J4's joins run in the program (no eager HashJoin leaf),
  the counted ones are counted, J3's emit reuses the count's sort and
  G1's the count's grouping;
* a warm counted query reads the device twice (the count, the result's
  row count);
* a table registered anew captures the count program again and then the
  emit program, which reads the count program's output planes.
"""

import pytest
import torch

from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.tpch import count_emit as CE
from query_engine_tpu_torch.tpch import data

pytestmark = pytest.mark.cuda

N_LI = 1 << 14
SHAPES = [q for q in CE.QUERIES if q not in CE.FD_QUERIES]


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables():
    return data.generate(N_LI)


@pytest.fixture(scope="module")
def sessions(tables):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    cpu, gpu = Session("cpu"), Session("cuda")
    for s in (cpu, gpu):
        data.register(s, tables)
    return cpu, gpu


@pytest.mark.parametrize("q", SHAPES + list(CE.FD_QUERIES))
def test_query_on_card_matches_oracle_and_cpu(sessions, tables, q):
    cpu, gpu = sessions
    pipe = gpu.executor.pipeline
    want = CE.run(q, tables)
    st0 = dict(pipe.stats)
    leaves0 = sum(pipe.leaf_kinds.values())
    CE.compare(q, gpu.sql(CE.QUERIES[q]).to_pylist(), want)
    first = {k: pipe.stats[k] - st0[k] for k in st0
             if isinstance(st0[k], int)}
    assert first["compiles"] >= 1 and first["captures"] == first["compiles"]
    assert not first["joins_demoted"], first
    if q in CE.JOINS:
        assert "HashJoin" not in pipe.leaf_kinds, pipe.leaf_kinds
    if q in CE.COUNTED:
        assert first["joins_counted"] >= 1, first
    if q in CE.SORT_REUSED:
        assert first["join_sorts_reused"] >= 1, first
    if q in CE.GROUPING_REUSED:
        assert first["group_sorts_reused"] >= 1, first
    st1, syncs = dict(pipe.stats), gpu.executor.host_syncs
    for _ in range(2):
        CE.compare(q, gpu.sql(CE.QUERIES[q]).to_pylist(), want)
    if sum(pipe.leaf_kinds.values()) == leaves0:
        assert pipe.stats["captures"] == st1["captures"], pipe.stats
        assert pipe.stats["compiles"] == st1["compiles"], pipe.stats
        assert pipe.stats["replays"] >= st1["replays"] + 2, pipe.stats
        reads = 1 + first["joins_counted"]
        assert gpu.executor.host_syncs - syncs == 2 * reads
    CE.compare(q, cpu.sql(CE.QUERIES[q]).to_pylist(), want)


def test_emit_captures_again_when_its_count_program_does(tables):
    """The emit program reads the count program's output planes: warm runs
    replay both; a table registered anew (new planes) captures the count
    program again, then the emit program (its handed-over planes moved);
    the rows are the new table's."""
    s = Session("cuda")
    data.register(s, tables)
    pipe = s.executor.pipeline
    q = CE.QUERIES["J3"]
    want = CE.run("J3", tables)
    CE.compare("J3", s.sql(q).to_pylist(), want)
    st = dict(pipe.stats)
    CE.compare("J3", s.sql(q).to_pylist(), want)
    assert pipe.stats["captures"] == st["captures"]
    assert pipe.stats["replays"] == st["replays"] + 2
    s.register_table("partsupp", tables["partsupp"].to_batch(s.device))
    st = dict(pipe.stats)
    CE.compare("J3", s.sql(q).to_pylist(), want)
    assert pipe.stats["compiles"] == st["compiles"]
    assert pipe.stats["captures"] == st["captures"] + 2
    assert pipe.stats["replays"] == st["replays"] + 2
