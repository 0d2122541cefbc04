"""TPC-H's refresh functions and the Session surface of `chip_smoke.py`'s
phase 11 (`query_engine_tpu_torch.tpch.refresh`) at
`benchmarks/tpch_mini.build(1 << 11)`:

* the port's Session runs M1-M12 (CREATE INDEX, parametrized index
  lookups, Q6 with parameters, RF1 as INSERT ... VALUES ... RETURNING and
  INSERT ... SELECT, Q1/Q3/Q18, RF2 as DELETE ... IN (...), UPDATE, Q10,
  INSERT ... ON CONFLICT, a transaction with a savepoint, Q15's view form
  through sql_script, CREATE TABLE AS / ALTER / DROP / TRUNCATE) and every
  statement's rows equal the numpy oracle's on the edited tables, in the
  three modes of `torch_session_diff`; the index lookups run as IndexScan;
* the same statements through the JAX Session give the same statuses and
  rows, except RF1, which the JAX Session cannot run on these tables (its
  INSERT encoder takes no date: ExecutionError for DATE '...' literals,
  TypeError for INSERT ... SELECT), so both Sessions skip it there;
* M13: with the result cache on, a repeated Q1 runs no program, a DML
  statement clears it, and the next Q1 is the new oracle's;
* M14: rounds of RF1, RF2 and Q1 leave no more compiled programs than the
  first round did (a replaced table's programs are dropped).
"""

import numpy as np
import pytest

from torch_session_diff import MODES, outcome, port_session, same

from benchmarks import tpch_mini
from query_engine_tpu_torch.tpch import data, oracle, refresh

N_LI = 1 << 11
SEED = 11


@pytest.fixture(scope="module")
def host_tables():
    return data.generate(N_LI)


def _port(host_tables, mode, **kwargs):
    s = port_session(mode, **kwargs)
    data.register(s, host_tables)
    return s


def _check(s, st, step):
    got = refresh.run_step(s, step)
    if step.want is not None:
        oracle.compare(got, step.want(st), step.float_keys)
    if step.edit is not None:
        step.edit(st)
    return got


@pytest.mark.parametrize("mode", MODES)
def test_phase_statements_match_oracle(host_tables, mode):
    s = _port(host_tables, mode)
    st = refresh.State(dict(host_tables))
    count = refresh.refresh_count(N_LI)
    rf = refresh.make_rf1(st, count, SEED)
    refresh.register_staging(s, rf)
    labels = set()
    for step in refresh.steps(st, count, SEED, rf):
        scans = s.executor.index_scans
        _check(s, st, step)
        labels.add(step.label)
        if step.index_scan:
            assert s.executor.index_scans == scans + 1, step.sql
    rf2 = refresh.make_rf1(st, count, SEED + 10)
    refresh.register_staging(s, rf2)
    for step in refresh.transaction_steps(st, count, SEED + 10, rf2):
        _check(s, st, step)
        labels.add(step.label)
    for step in refresh.ddl_steps(st):
        _check(s, st, step)
        labels.add(step.label)
    assert labels == {f"M{i}" for i in range(1, 13)}
    assert not s.in_transaction()
    if mode != "QE_COMPILED=0":
        assert s.executor.pipeline.stats["fallbacks"] == 0


def _jax_batch(t):
    """A host table as a JAX-package batch (dates as DATE32 days)."""
    from query_engine_tpu.columnar.batch import ColumnBatch
    from query_engine_tpu.core.schema import Field, Schema
    from query_engine_tpu.core.types import DataType

    types = {"Int64": DataType.int64(), "Float64": DataType.float64(),
             "Utf8": DataType.utf8(), "Date32": DataType.date32()}
    fields, cols = [], {}
    for f in t.fields:
        fields.append(Field(f.name, types[f.data_type.kind.value]))
        v = t.columns[f.name]
        cols[f.name] = [str(x) for x in t.dicts[f.name][v]] \
            if f.name in t.dicts else v.tolist()
    return ColumnBatch.from_pydict(cols, Schema(fields))


def _is_rf1(step):
    return step.sql.startswith(("INSERT INTO orders", "INSERT INTO lineitem"))


def test_phase_statements_match_jax(host_tables):
    js, _ = tpch_mini.build(N_LI)
    ts = _port(host_tables, "compiled")
    st = refresh.State(dict(host_tables))
    count = refresh.refresh_count(N_LI)
    rf = refresh.make_rf1(st, count, SEED)
    refresh.register_staging(ts, rf)
    for name, t in refresh.staging(rf).items():
        js.register_table(name, _jax_batch(t))
    steps = list(_lazy(refresh.steps, st, count, SEED, rf))
    rf2 = refresh.make_rf1(st, count, SEED + 10)
    steps += list(_lazy(refresh.transaction_steps, st, count, SEED + 10, rf2))
    steps += list(_lazy(refresh.ddl_steps, st))
    skipped = 0
    for step, edit in steps:
        if _is_rf1(step):
            # the JAX Session's INSERT encoder takes no date (tried outside
            # the transaction: an error inside one aborts it)
            if step.label == "M4":
                err = outcome(js, step.sql)
                assert err in (("error", "TypeError"),
                               ("error", "ExecutionError")), err
            skipped += 1
            continue
        if step.script:
            want = [b.to_pylist() for b in js.sql_script(step.sql)]
            assert [b.to_pylist() for b in ts.sql_script(step.sql)] == want
        else:
            want = outcome(js, step.sql, step.params)
            got = outcome(ts, step.sql, step.params)
            assert same(got, want), (step.label, step.sql[:80], got, want)
            assert want[0] == "ok", want
    assert skipped == 6


def _lazy(gen, st, *args):
    """The steps of `gen` with their edits applied to `st` as they come,
    RF1's skipped (so the oracle state follows the JAX Session's)."""
    for step in gen(st, *args):
        yield step, step.edit
        if step.edit is not None and not _is_rf1(step):
            step.edit(st)


def test_m13_result_cache(host_tables):
    """Q1 twice with the cache on: the second is a hit that runs no
    program; a DELETE clears the cache; the third Q1 is the new oracle's."""
    s = _port(host_tables, "graphs", enable_cache=True)
    st = refresh.State(dict(host_tables))
    q1 = refresh.QUERIES["Q1"]
    oracle.compare(s.sql(q1).to_pylist(), oracle.run("Q1", st.tables))
    stats = dict(s.executor.pipeline.stats)
    syncs = s.executor.host_syncs
    again = s.sql(q1).to_pylist()
    assert s.executor.pipeline.stats == stats
    assert s.executor.host_syncs == syncs
    assert s._cache.stats.hits == 1
    keys = refresh.rf2_keys(st, refresh.refresh_count(N_LI))
    for step in refresh.rf2_steps(st, keys, "M13"):
        _check(s, st, step)
    assert len(s._cache) == 0
    third = s.sql(q1).to_pylist()
    oracle.compare(third, oracle.run("Q1", st.tables))
    assert third != again
    assert s.executor.pipeline.stats["compiles"] > stats["compiles"]


def test_m14_rounds_leave_no_programs_behind(host_tables):
    """Three rounds of RF1, RF2 and Q1: each equals the oracle, and the
    compiled programs that read a replaced table are dropped, so the
    cache holds no more entries after round 3 than after round 1."""
    s = _port(host_tables, "graphs")
    st = refresh.State(dict(host_tables))
    count = refresh.refresh_count(N_LI)
    s.sql("CREATE INDEX orders_pk ON orders (o_orderkey)")
    sizes = []
    for r in range(3):
        rf = refresh.make_rf1(st, count, SEED + 20 + r)
        refresh.register_staging(s, rf)
        for step in refresh.rf1_steps(st, rf, "M14"):
            _check(s, st, step)
        for step in refresh.rf2_steps(st, refresh.rf2_keys(st, count),
                                      "M14"):
            _check(s, st, step)
        oracle.compare(s.sql(refresh.QUERIES["Q1"]).to_pylist(),
                       oracle.run("Q1", st.tables))
        sizes.append(len(s.executor.pipeline._cache))
    assert sizes[2] <= sizes[0], sizes
    n_orders = int((~st.deleted).sum())
    assert s.sql("SELECT COUNT(*) FROM orders").to_pylist() == [(n_orders,)]
    k = int(st.live_keys()[-1])
    assert s.sql(refresh.ORDER_BY_KEY, [k]).to_pylist() == \
        refresh.orders_rows(st, k, k + 1, ("o_orderkey", "o_custkey",
                                           "o_orderdate", "o_totalprice"))


def test_refresh_sets_follow_the_specification(host_tables):
    """RF1: `count` orders with keys above the largest, 1-7 lineitems each
    with dates after their order's; RF2: the lowest present keys."""
    st = refresh.State(dict(host_tables))
    count = refresh.refresh_count(N_LI)
    assert count == refresh.MIN_REFRESH
    assert refresh.refresh_count(data.SF1_LINEITEM) == 1500
    rf = refresh.make_rf1(st, count, SEED)
    keys = rf.orders.columns["o_orderkey"]
    assert keys[0] == host_tables["orders"].num_rows and len(keys) == count
    per = np.bincount(rf.lineitem.columns["l_orderkey"] - keys[0])
    assert per.min() >= 1 and per.max() <= 7 and len(per) == count
    odate = rf.orders.columns["o_orderdate"][
        rf.lineitem.columns["l_orderkey"] - keys[0]]
    assert (rf.lineitem.columns["l_shipdate"] > odate).all()
    refresh.apply_rf1(st, rf)
    gone = refresh.rf2_keys(st, count)
    assert list(gone) == list(range(count))
    refresh.apply_rf2(st, gone)
    assert list(refresh.rf2_keys(st, 3)) == [count, count + 1, count + 2]
    assert not np.isin(st.tables["lineitem"].columns["l_orderkey"],
                       gone).any()
