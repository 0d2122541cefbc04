"""The host services over the card: pgwire, the streaming device table and
`to_arrow`'s host step on CUDA planes, held against a CPU Session on the
same data. Each test skips without a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_services_cuda.py -m cuda

* a pgwire round trip over `Session(device="cuda")` with the server in its
  thread: the request's first run of a GROUP BY captures its program into
  a CUDA graph inside the server thread, the second replays it, and the
  messages equal the CPU server's byte for byte, floats within rtol 1e-9;
* `DeviceStreamTable` on the card: append, growth and a dictionary merge
  leave a snapshot's rows as they were; a tumbling stream's windows equal
  the CPU stream's, and the later windows replay the first one's program;
* `ColumnBatch.host_planes`/`host_pylists` on CUDA planes (one transfer)
  give `Column.to_pylist`'s values;
* `PgServer()` and `StreamingQuery` with no device argument put their
  Session on the card;
* two Sessions capture in two threads while a third thread reads from the
  card: the pipeline's thread-local capture mode and capture lock keep
  every capture, and every replay gives the CPU Session's rows.
"""

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.pgwire.server import PgServer
from query_engine_tpu_torch.streaming.device_table import DeviceStreamTable
from query_engine_tpu_torch.streaming.source import MemoryStreamSource
from query_engine_tpu_torch.streaming.stream import (
    StreamConfig, StreamingQuery,
)
from query_engine_tpu_torch.streaming.window import WindowSpec, WindowType

from torch_pg_wire import ServerThread, WireClient, same_messages

pytestmark = pytest.mark.cuda

GROUP_BY = ("SELECT k, COUNT(*) AS n, SUM(v) AS s, AVG(x) AS a, MIN(t) AS m "
            "FROM t WHERE v > 10 GROUP BY k ORDER BY k")


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _table(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 40, n).tolist(),
            "v": rng.integers(0, 1000, n).tolist(),
            "x": np.round(rng.uniform(-5, 5, n), 3).tolist(),
            "t": rng.choice(["red", "green", "blue", None], n).tolist()}


def test_pgwire_round_trip_with_a_capture_in_the_server_thread():
    data = _table()
    sessions = {"cuda": Session(device="cuda"), "cpu": Session(device="cpu")}
    got = {}
    for dev, s in sessions.items():
        s.register_table("t", data)
        srv = ServerThread(PgServer(s, "127.0.0.1", 0)).start()
        try:
            c = WireClient("127.0.0.1", srv.port)
            st0 = dict(s.executor.pipeline.stats)
            first = c.query_raw(GROUP_BY)
            st1 = dict(s.executor.pipeline.stats)
            again = c.query_raw(GROUP_BY)
            st2 = dict(s.executor.pipeline.stats)
            c.close()
        finally:
            srv.stop()
        assert first == again
        got[dev] = first
        if dev == "cuda":
            assert st1["captures"] == st0["captures"] + 1, (st0, st1)
            assert st2["replays"] == st1["replays"] + 1, (st1, st2)
            assert st2["captures"] == st1["captures"]
    assert [t for t, _ in got["cuda"]].count(b"D") == 40
    # the card sums floats in fixed point: AVG's text may differ in its
    # last digits, within rtol 1e-9
    same_messages(got["cuda"], got["cpu"])


def _batches(device, n_batches=9, rows=3000, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        tags = ["x", "y"] if b < 3 else ["a", "x", "y", "z"]  # a merge
        out.append(ColumnBatch.from_pydict({
            "k": rng.integers(0, 7, rows).tolist(),
            "v": rng.integers(1, 100, rows).tolist(),
            "f": np.round(rng.uniform(0, 1, rows), 4).tolist(),
            "tag": rng.choice(tags, rows).tolist(),
        }, device=device))
    return out


def test_device_table_snapshot_guarantee_on_the_card(cuda_device):
    bs = _batches("cpu")
    t = DeviceStreamTable(bs[0].schema, 1024, cuda_device)
    t.append(bs[0])
    t.append(bs[1])
    snap = t.snapshot()
    want = snap.to_pylist()
    assert all(c.data.is_cuda for c in snap.columns)
    cap0 = t.capacity
    for b in bs[2:]:
        t.append(b)  # growth, and bs[3] brings 'a': a merge
    assert t.capacity > cap0 and t.dict_merges >= 1
    assert snap.to_pylist() == want
    assert t.snapshot().to_pylist() == ColumnBatch.concat(bs).to_pylist()
    assert t.upload_rows == sum(b.num_rows for b in bs)


def test_tumbling_windows_on_the_card_replay():
    q = ("SELECT k, tag, COUNT(*) AS n, SUM(v) AS s, AVG(f) AS a "
         "FROM stream GROUP BY k, tag ORDER BY k, tag")
    out = {}
    for dev in ("cuda", "cpu"):
        class Clock:
            t = 0.0

            def __call__(self):
                return self.t

        clock = Clock()

        class Src(MemoryStreamSource):
            def next_batch(self, timeout=None):
                b = super().next_batch(timeout)
                clock.t += b is not None
                return b

        sq = StreamingQuery(
            Src(_batches("cpu", n_batches=12, seed=8)),
            StreamConfig(batch_size=4096, window=WindowSpec(
                WindowType.TUMBLING, size_secs=4)),
            query=q, clock=clock, device=dev)
        out[dev] = ([r.to_pylist() for r in sq.run()], sq)
    rows, sq = out["cuda"]
    assert len(rows) == 3
    for a, b in zip(rows, out["cpu"][0]):
        assert [r[:3] for r in a] == [r[:3] for r in b]
        assert all(x[3] == y[3] and abs(x[4] - y[4]) <= 1e-9 * abs(y[4])
                   for x, y in zip(a, b))
    stats = sq._session.executor.pipeline.stats
    # windows 2 and 3 run the program of window 1 over the same planes
    assert stats["replays"] >= 2 and stats["captures"] == 1, stats


def test_host_planes_on_the_card():
    s = Session(device="cuda")
    s.register_table("t", _table(300))
    for sql in ("SELECT * FROM t", GROUP_BY,
                "SELECT k, DATE '2024-01-01' AS d, CAST(v AS DECIMAL(9, 2)) "
                "AS dec, v > 500 AS big FROM t ORDER BY k, v LIMIT 50",
                "SELECT 1, NULL, 'a'"):
        b = s.sql(sql)
        assert all(c.data.is_cuda for c in b.columns)
        assert b.host_pylists() == [c.to_pylist(b.num_rows)
                                    for c in b.columns]
        for (d, v), c in zip(b.host_planes(), b.columns):
            assert np.array_equal(d, c.data[:b.num_rows].cpu().numpy())
            assert np.array_equal(v, c.validity[:b.num_rows].cpu().numpy())


def test_services_default_to_the_card():
    server = PgServer(port=0)
    assert server.session.device.type == "cuda"
    sq = StreamingQuery(MemoryStreamSource(
        [ColumnBatch.from_pydict({"k": [1, 2, 3]})]),
        query="SELECT SUM(k) FROM stream")
    assert sq.device.type == "cuda"
    assert [r.to_pylist() for r in sq.run()] == [[(6,)]]
    assert sq._session.device.type == "cuda"
    assert sq._dev_table.datas[0].is_cuda


SHAPES = ["SELECT k, COUNT(*) AS n FROM t GROUP BY k ORDER BY k",
          "SELECT k, SUM(v) AS s FROM t WHERE v > 10 GROUP BY k ORDER BY k",
          "SELECT t, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY t ORDER BY t",
          "SELECT k, MIN(x) AS m, MAX(v) AS w FROM t GROUP BY k ORDER BY k",
          "SELECT SUM(v) AS s, COUNT(*) AS n FROM t WHERE x > 0",
          "SELECT k, t, COUNT(*) AS n FROM t GROUP BY k, t ORDER BY k, t"]


def test_two_sessions_capture_in_two_threads():
    import concurrent.futures
    import threading

    data = _table()
    cpu = Session(device="cpu")
    cpu.register_table("t", data)
    want = [cpu.sql(q).to_pylist() for q in SHAPES]
    stop = threading.Event()
    reads = []

    def reader():
        x = torch.arange(1 << 20, device="cuda", dtype=torch.float64)
        while not stop.is_set():
            reads.append((x * 2).sum().item())

    def queries(order):
        s = Session(device="cuda")
        s.register_table("t", data)
        got = {}
        for i in order:
            first = s.sql(SHAPES[i]).to_pylist()
            got[i] = (first, s.sql(SHAPES[i]).to_pylist())
        return got, dict(s.executor.pipeline.stats)

    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        hammer = ex.submit(reader)
        runs = [ex.submit(queries, order) for order in
                (range(len(SHAPES)), reversed(range(len(SHAPES))))]
        try:
            results = [f.result(300) for f in runs]
        finally:
            stop.set()
        hammer.result(60)
    assert reads and all(r == reads[0] for r in reads)
    for got, stats in results:
        assert stats["captures"] == len(SHAPES), stats
        assert stats["replays"] == len(SHAPES), stats
        for i, (first, again) in got.items():
            assert first == again
            assert _close(first, want[i]), (i, first, want[i])


def _close(got, want, rtol=1e-9):
    """Rows equal, floats within rtol (the card sums floats in fixed
    point)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                if abs(a - b) > rtol * abs(b):
                    return False
            elif a != b:
                return False
    return True
