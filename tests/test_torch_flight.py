"""The port's Flight server, client and data sources against the JAX
package's.

The Flight cases of tests/test_streaming_flight.py run against both
servers (the JAX Session and the port's `Session(device="cpu")`), each
through its own package's client, with the reference's assertions, and the
rows must be equal. The port's `ColumnBatch.to_arrow` gives the JAX
package's RecordBatch. Needs pyarrow.flight.
"""

import datetime
import time

import pytest

flight = pytest.importorskip("pyarrow.flight")

from query_engine_tpu.columnar.batch import ColumnBatch as JBatch  # noqa: E402
from query_engine_tpu.core.config import FlightConfig as JConfig  # noqa: E402
from query_engine_tpu.core.errors import FlightError as JFlightError  # noqa: E402
from query_engine_tpu.flight import client as jclient  # noqa: E402
from query_engine_tpu.flight import data_source as jds  # noqa: E402
from query_engine_tpu.flight import server as jserver  # noqa: E402
from query_engine_tpu_torch.columnar.batch import ColumnBatch as TBatch  # noqa: E402
from query_engine_tpu_torch.core.config import FlightConfig as TConfig  # noqa: E402
from query_engine_tpu_torch.core.errors import FlightError as TFlightError  # noqa: E402
from query_engine_tpu_torch.engine.session import Session as TSession  # noqa: E402
from query_engine_tpu_torch.flight import client as tclient  # noqa: E402
from query_engine_tpu_torch.flight import data_source as tds  # noqa: E402
from query_engine_tpu_torch.flight import server as tserver  # noqa: E402

PKGS = {
    "jax": (JBatch, JConfig, JFlightError, jclient, jds, jserver, None),
    "torch": (TBatch, TConfig, TFlightError, tclient, tds, tserver,
              lambda: TSession(device="cpu")),
}


@pytest.fixture(scope="module")
def services():
    out = {}
    for pkg, (Batch, Config, _, _, _, server, session) in PKGS.items():
        svc = server.FlightServiceImpl(
            Config(host="127.0.0.1", port=0),
            session() if session is not None else None)
        svc.session.register_table("nums", Batch.from_pydict(
            {"n": [1, 2, 3, 4], "s": ["a", "b", "c", "d"]}))
        svc.serve_thread = __import__("threading").Thread(
            target=svc.serve, daemon=True)
        svc.serve_thread.start()
        out[pkg] = svc
    time.sleep(0.3)
    yield out
    for svc in out.values():
        svc.shutdown()
        svc.serve_thread.join(10)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return request.param


def url(services, pkg):
    return f"grpc://127.0.0.1:{services[pkg].port}"


def test_flight_execute_sql(services, pkg):
    c = PKGS[pkg][3].FlightClient(url(services, pkg))
    out = c.execute_sql("SELECT n, s FROM nums WHERE n > 2 ORDER BY n")
    assert out.to_pylist() == [(3, "c"), (4, "d")]
    assert c.handshake()
    c.close()


def test_flight_upload_list_and_info(services, pkg):
    Batch, client = PKGS[pkg][0], PKGS[pkg][3]
    c = client.FlightClient(url(services, pkg))
    c.upload_table("uploaded", Batch.from_pydict({"x": [10, 20]}))
    assert "uploaded" in c.list_tables()
    out = c.execute_sql("SELECT SUM(x) FROM uploaded")
    assert out.to_pylist() == [(30,)]
    schema = c.get_table_schema("uploaded")
    assert schema.names == ["x"]
    flights = c.list_flights()
    assert any(f.descriptor.path == [b"uploaded"] for f in flights)
    c.close()


def test_flight_exchange_and_data_source(services, pkg):
    Batch, client, ds = PKGS[pkg][0], PKGS[pkg][3], PKGS[pkg][4]
    u = url(services, pkg)
    c = client.FlightClient(u)
    echoed = c.exchange(Batch.from_pydict({"e": [7, 8]}))
    assert echoed.to_pylist() == [(7,), (8,)]
    c.close()

    src = ds.FlightDataSource(u, "SELECT n FROM nums ORDER BY n")
    assert src.scan().to_pylist() == [(1,), (2,), (3,), (4,)]
    ss = ds.FlightStreamSource(u, "SELECT n FROM nums ORDER BY n",
                               batch_rows=3)
    got = []
    while not ss.is_exhausted():
        b = ss.next_batch()
        got.extend(b.to_pylist())
    assert got == [(1,), (2,), (3,), (4,)]


def test_flight_poll_flight_info(services, pkg):
    c = PKGS[pkg][3].FlightClient(url(services, pkg))
    # path-based poll (reference server.rs:283-321): always complete
    info = c.poll_flight_info(name="nums")
    assert info["progress"] == 1.0
    assert info["ticket"] == "nums"
    assert info["total_records"] == 4
    assert info["schema"].names == ["n", "s"]
    # command-based poll runs the query for schema/row count
    info = c.poll_flight_info(sql="SELECT n FROM nums WHERE n > 2")
    assert info["progress"] == 1.0
    assert info["total_records"] == 2
    assert info["schema"].names == ["n"]
    # unknown table -> error
    with pytest.raises(Exception):
        c.poll_flight_info(name="missing_table")
    c.close()


def test_flight_error_propagates(services, pkg):
    c = PKGS[pkg][3].FlightClient(url(services, pkg))
    with pytest.raises(PKGS[pkg][2]):
        c.execute_sql("SELECT * FROM missing_table")
    c.close()


def test_same_rows_through_both_servers(services):
    """One query through each server and each client: the same rows, and
    the port's client reads the JAX server and the other way round."""
    sql = ("SELECT n, s, n * 1.5 AS f, n % 2 = 0 AS even FROM nums "
           "ORDER BY n")
    rows = {}
    for srv in PKGS:
        for cli in PKGS:
            c = PKGS[cli][3].FlightClient(url(services, srv))
            rows[srv, cli] = c.execute_sql(sql).to_pylist()
            c.close()
    assert len(set(map(tuple, rows.values()))) == 1
    assert rows["jax", "jax"][1] == (2, "b", 3.0, True)


def test_to_arrow_matches_jax():
    data = {"i": [1, None, 3], "f": [0.5, -1.25, None],
            "s": ["x", None, "y"], "b": [True, False, None]}
    want = JBatch.from_pydict(data).to_arrow()
    got = TBatch.from_pydict(data).to_arrow()
    assert got.equals(want)
    # a DATE and a TIMESTAMP column, through each Session
    from query_engine_tpu.engine.session import Session as JSession

    sql = ("SELECT k, DATE '2024-01-02' AS d, "
           "TIMESTAMP '2024-01-02 03:04:05' AS ts FROM t ORDER BY k")
    batches = []
    for s in (JSession(), TSession(device="cpu")):
        s.register_table("t", {"k": [1, 2]})
        batches.append(s.sql(sql).to_arrow())
    assert batches[1].equals(batches[0])
    assert batches[1].column(1).to_pylist() == [datetime.date(2024, 1, 2)] * 2


def test_flight_server_defaults_to_the_card():
    """FlightServer() builds Session(), which lies on the card: without
    CUDA it raises."""
    import torch

    config = TConfig(host="127.0.0.1", port=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserver.FlightServer(config)
        return
    server = tserver.FlightServer(config)
    try:
        assert server.session.device.type == "cuda"
    finally:
        server.shutdown()


def test_pgwire_and_flight_over_one_session_take_turns():
    """A pgwire server and a Flight server over one Session hold the
    Session's one lock: while another thread holds it, neither answers,
    and both answer once it is free."""
    import concurrent.futures

    from query_engine_tpu_torch.pgwire.server import PgServer
    from torch_pg_wire import ServerThread, WireClient

    sess = TSession(device="cpu")
    sess.register_table("nums", TBatch.from_pydict({"n": [1, 2, 3, 4]}))
    svc = tserver.FlightServiceImpl(TConfig(host="127.0.0.1", port=0), sess)
    serve = __import__("threading").Thread(target=svc.serve, daemon=True)
    serve.start()
    pg = ServerThread(PgServer(sess, "127.0.0.1", 0)).start()
    sql = "SELECT SUM(n) FROM nums"
    try:
        wire = WireClient("127.0.0.1", pg.port)
        fl = tclient.FlightClient(f"grpc://127.0.0.1:{svc.port}")
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            with sess.lock:
                futures = [ex.submit(lambda: wire.query(sql)[1]),
                           ex.submit(lambda: fl.execute_sql(sql)
                                     .to_pylist())]
                done, _ = concurrent.futures.wait(futures, timeout=0.5)
                assert not done
            assert [f.result(30) for f in futures] == [[("10",)], [(10,)]]
        wire.close()
        fl.close()
    finally:
        pg.stop()
        svc.shutdown()
        serve.join(10)


def test_shutdown_lets_go_of_the_session():
    """pyarrow keeps a Flight server object alive after it stops (its C++
    side holds it); the port's server lets go of its Session on shutdown,
    so the Session's tables on the card are freed with it."""
    import gc
    import threading
    import weakref

    sess = TSession(device="cpu")
    sess.register_table("nums", TBatch.from_pydict({"n": [1, 2, 3, 4]}))
    svc = tserver.FlightServiceImpl(TConfig(host="127.0.0.1", port=0), sess)
    serve = threading.Thread(target=svc.serve, daemon=True)
    serve.start()
    fl = tclient.FlightClient(f"grpc://127.0.0.1:{svc.port}")
    assert fl.execute_sql("SELECT SUM(n) FROM nums").to_pylist() == [(10,)]
    fl.close()
    svc.shutdown()
    serve.join(10)
    planes = weakref.ref(sess.sources["nums"]._batch.columns[0].data)
    del sess, svc, fl, serve
    gc.collect()
    assert planes() is None
