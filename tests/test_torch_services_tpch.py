"""TPC-H through both pgwire servers, and the host services without JAX.

* Six TPC-H queries at `tpch_mini.build(1 << 11)` go through the JAX
  package's pgwire server (tpch_mini's JAX Session) and the port's (the same
  tables from `tpch.data.generate`, `Session(device="cpu")`) over TCP. The
  messages must be equal byte for byte, except that a float field (type
  OID 701) may differ in its text when both values agree within rtol 1e-9
  (the JAX package's result is float64 on the CPU, summed in another
  order); the rows are also held against the numpy oracle.
* The Q6 text with parameters, through the extended protocol of both.
* The port's pgwire, streaming, CLI and Flight modules import and serve
  with `jax` and `query_engine_tpu` blocked from import.
"""

import os
import subprocess
import sys

import pytest

from benchmarks import tpch_mini
from query_engine_tpu.pgwire import server as jserver
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.pgwire import server as tserver
from query_engine_tpu_torch.tpch import data, oracle, queries

from torch_pg_wire import ServerThread, WireClient, same_messages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LI = 1 << 11
QUERIES = ("Q1", "Q3", "Q6", "Q10", "Q13", "Q18")


@pytest.fixture(scope="module")
def tables():
    return data.generate(N_LI)


@pytest.fixture(scope="module")
def servers(tables):
    js, _ = tpch_mini.build(N_LI)
    ts = Session(device="cpu")
    data.register(ts, tables)
    threads = {
        "jax": ServerThread(jserver.PgServer(js, "127.0.0.1", 0)).start(),
        "torch": ServerThread(tserver.PgServer(ts, "127.0.0.1", 0)).start(),
    }
    yield threads
    for t in threads.values():
        t.stop()


def exchange(servers, run):
    out = {}
    for pkg, srv in servers.items():
        c = WireClient("127.0.0.1", srv.port)
        try:
            out[pkg] = run(c)
        finally:
            c.close()
    return out


@pytest.mark.parametrize("q", QUERIES)
def test_tpch_over_both_servers(servers, tables, q):
    text = queries.QUERIES[q]
    msgs = exchange(servers, lambda c: c.query_raw(text))
    same_messages(msgs["torch"], msgs["jax"])
    c = WireClient.__new__(WireClient)
    _, rows, tags = c.typed(msgs["torch"])
    oracle.compare(rows, oracle.run(q, tables),
                   oracle.FLOAT_SORT_KEYS.get(q, ()))
    assert tags == [f"SELECT {len(rows)}"] and rows


def test_q6_parameters_over_both_servers(servers, tables):
    """Q6 with $1-$3 (`refresh.Q6_PARAM`): Parse once, Describe, then Bind
    and Execute with two sets of literals, each against its oracle."""
    from query_engine_tpu_torch.tpch import refresh

    sets = (refresh.Q6_PARAMS, ["1995-01-01", 0.02, 20])

    def run(c):
        c.parse("q6", refresh.Q6_PARAM)
        c.describe("S", "q6")
        msgs = [c.sync()]
        for params in sets:
            c.bind("q6", params)
            c.execute()
            msgs.append(c.sync())
        return msgs

    msgs = exchange(servers, run)
    for got, want in zip(msgs["torch"], msgs["jax"]):
        same_messages(got, want)
    assert [t for t, _ in msgs["torch"][0]] == [b"1", b"t", b"T", b"Z"]
    assert WireClient.parameter_oids(msgs["torch"][0][1][1]) == []
    c = WireClient.__new__(WireClient)
    for params, got in zip(sets, msgs["torch"][1:]):
        assert [t for t, _ in got] == [b"2", b"D", b"C", b"Z"]
        _, rows, _ = c.typed([msgs["torch"][0][2]] + got)
        oracle.compare(rows, refresh.q6_rows(tables, *params))


def test_services_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['query_engine_tpu'] = None\n"
        "from query_engine_tpu_torch.cli import commands, format, main, repl\n"
        "from query_engine_tpu_torch.flight import client, data_source, server\n"
        "from query_engine_tpu_torch.pgwire import (auth, catalog, cursor,\n"
        "    protocol, result, server as pg, tls)\n"
        "from query_engine_tpu_torch.streaming import (device_table, source,\n"
        "    stream, watermark, window)\n"
        "from query_engine_tpu_torch.columnar.batch import ColumnBatch\n"
        "from query_engine_tpu_torch.engine.session import Session\n"
        "from torch_pg_wire import ServerThread, WireClient\n"
        "s = Session(device='cpu')\n"
        "s.register_table('t', {'k': [1, 2, 2], 'v': [1.5, 2.5, 3.5]})\n"
        "srv = ServerThread(pg.PgServer(s, '127.0.0.1', 0)).start()\n"
        "c = WireClient('127.0.0.1', srv.port)\n"
        "_, rows, _ = c.typed_query('SELECT k, SUM(v) FROM t GROUP BY k "
        "ORDER BY k')\n"
        "c.close(); srv.stop()\n"
        "assert rows == [(1, 1.5), (2, 6.0)], rows\n"
        "b = ColumnBatch.from_pydict({'k': [1, 2, 2]})\n"
        "q = stream.StreamingQuery(source.MemoryStreamSource([b, b]),\n"
        "    query='SELECT COUNT(*) FROM stream', device='cpu')\n"
        "assert [r.to_pylist() for r in q.run()] == [[(6,)]]\n"
        "r = repl.Repl(session=s)\n"
        "assert '2 row(s)' in r.handle('SELECT DISTINCT k FROM t')\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and (m == 'jax' or m.startswith('jax.')\n"
        "                  or m.startswith('query_engine_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
