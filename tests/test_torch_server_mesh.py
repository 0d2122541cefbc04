"""The port's servers ride the mesh: the three cases of
tests/test_server_mesh.py. A pgwire server and a Flight server over the
port's `Session(device="cpu", mesh=make_mesh(["cpu"] * 8))`, and a
StreamingQuery whose per-window Session `QE_MESH_DEVICES=8` makes a mesh
Session of 8 CPU shards, each run the reference case's query; the rows
must equal the JAX package's single-device Session's (pgwire's as text on
the wire), and the query must have run as a mesh program.
"""

import threading
import time

import pytest

from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.parallel.mesh import make_mesh
from pg_client import PgTestClient
from torch_pg_wire import ServerThread

ORDERS = {
    "o_id": list(range(600)),
    "cust": [i * 7 % 40 for i in range(600)],
    "amount": [(i * 13) % 500 for i in range(600)],
}
CUSTOMERS = {
    "c_id": list(range(40)),
    "region": [i % 5 for i in range(40)],
}
SQL = (
    "SELECT region, COUNT(*), SUM(amount) FROM orders "
    "JOIN customers ON cust = c_id GROUP BY region ORDER BY region"
)


def _register(session):
    session.register_table("orders", ORDERS)
    session.register_table("customers", CUSTOMERS)
    return session


def _expected():
    return _register(JSession()).sql(SQL).to_pylist()


def _mesh_session():
    return _register(Session(device="cpu", mesh=make_mesh(["cpu"] * 8)))


def test_pgwire_serves_over_mesh():
    from query_engine_tpu_torch.pgwire.server import PgServer

    session = _mesh_session()
    srv = ServerThread(PgServer(session, "127.0.0.1", 0)).start()
    try:
        c = PgTestClient("127.0.0.1", srv.port)
        _, rows, _ = c.query(SQL)
        c.close()
    finally:
        srv.stop()
    # pgwire renders everything as text on the wire
    assert rows == [tuple(str(v) for v in r) for r in _expected()]
    assert session.mesh_pipeline.stats["queries"] >= 1
    assert session.mesh_pipeline.stats["compiles"] >= 1


def test_flight_serves_over_mesh():
    pytest.importorskip("pyarrow.flight")
    from query_engine_tpu_torch.core.config import FlightConfig
    from query_engine_tpu_torch.flight.client import FlightClient
    from query_engine_tpu_torch.flight.server import FlightServiceImpl

    session = _mesh_session()
    svc = FlightServiceImpl(FlightConfig(host="127.0.0.1", port=0),
                            session=session)
    t = threading.Thread(target=svc.serve, daemon=True)
    t.start()
    time.sleep(0.3)
    try:
        c = FlightClient(f"grpc://127.0.0.1:{svc.port}")
        out = c.execute_sql(SQL)
        c.close()
    finally:
        svc.shutdown()
        t.join(10)
    assert out.to_pylist() == _expected()
    assert session.mesh_pipeline.stats["queries"] >= 1


def test_streaming_rides_env_mesh(monkeypatch):
    """QE_MESH_DEVICES turns the streaming engine's per-window Session into
    a mesh Session with no code change; window results equal the JAX
    package's host engine's."""
    from query_engine_tpu.streaming.source import ChannelStreamSource as JSrc
    from query_engine_tpu.streaming.stream import StreamConfig as JConfig
    from query_engine_tpu.streaming.stream import StreamingQuery as JQuery
    from query_engine_tpu_torch.streaming.source import ChannelStreamSource
    from query_engine_tpu_torch.streaming.stream import (
        StreamConfig, StreamingQuery,
    )

    query = "SELECT k, SUM(v) FROM stream GROUP BY k ORDER BY k"
    batches = [{"k": [1, 2, 1, 3], "v": [10, 20, 30, 40]},
               {"k": [2, 2, 3, 1], "v": [5, 6, 7, 8]}]

    src = JSrc()
    for b in batches:
        src.send(JBatch.from_pydict(b))
    src.close()
    base = JQuery(src, JConfig(), query=query).run()

    monkeypatch.setenv("QE_MESH_DEVICES", "8")
    src = ChannelStreamSource()
    for b in batches:
        src.send(ColumnBatch.from_pydict(b))
    src.close()
    q = StreamingQuery(src, StreamConfig(), query=query, device="cpu")
    meshed = q.run()
    assert [b.to_pylist() for b in meshed] == [b.to_pylist() for b in base]
    # the device-buffer path keeps one persistent session: inspect it
    assert q._session is not None and q._session.mesh_pipeline is not None
    assert q._session.mesh_pipeline.n == 8
    assert q._session.mesh_pipeline.stats["queries"] >= 1
