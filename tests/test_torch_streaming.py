"""The port's streaming package against the JAX package's.

The streaming cases of tests/test_streaming_flight.py and the device-table
cases of tests/test_device_stream.py run against both packages (the port's
StreamingQuery and DeviceStreamTable on `device="cpu"`) with the
reference's assertions, and their window results must be equal. Then the
port's snapshot guarantee: a snapshot's rows, validity and strings keep
their values through later appends, growth and dictionary merges; a merge
recodes into a new plane; `clear()` keeps the planes (rows and validity
past `num_rows` included, as in the JAX table), an append after it writes
over an earlier snapshot's rows, and emitted window results never change.
"""

import types

import numpy as np
import pytest

from query_engine_tpu.columnar.batch import ColumnBatch as JBatch
from query_engine_tpu.streaming import device_table as jdt
from query_engine_tpu.streaming import source as jsource
from query_engine_tpu.streaming import stream as jstream
from query_engine_tpu.streaming import watermark as jwm
from query_engine_tpu.streaming import window as jwindow
from query_engine_tpu_torch.columnar.batch import ColumnBatch as TBatch
from query_engine_tpu_torch.streaming import device_table as tdt
from query_engine_tpu_torch.streaming import source as tsource
from query_engine_tpu_torch.streaming import stream as tstream
from query_engine_tpu_torch.streaming import watermark as twm
from query_engine_tpu_torch.streaming import window as twindow

PKGS = {
    "jax": types.SimpleNamespace(
        Batch=JBatch, source=jsource, stream=jstream, wm=jwm,
        window=jwindow, dt=jdt, kw={}),
    "torch": types.SimpleNamespace(
        Batch=TBatch, source=tsource, stream=tstream, wm=twm,
        window=twindow, dt=tdt, kw={"device": "cpu"}),
}


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return PKGS[request.param]


def batch(P, d):
    return P.Batch.from_pydict(d)


def query(P, src, config=None, **kw):
    return P.stream.StreamingQuery(src, config, **kw, **P.kw)


def table(P, schema, cap):
    return P.dt.DeviceStreamTable(schema, cap, **P.kw)


# ---- watermarks (reference watermark.rs tests) -----------------------------
def test_watermark_monotonic(P):
    w = P.wm.Watermark()
    assert w.advance(100)
    assert not w.advance(50)  # never goes backward
    assert w.current == 100
    assert w.is_late(99) and not w.is_late(100)


def test_late_event_policies(P):
    w = P.wm.Watermark()
    w.advance(1000)
    L = P.wm.LateEventPolicy
    assert not L.drop().should_allow_late(900, w)
    assert L.allow(200).should_allow_late(900, w)
    assert not L.allow(50).should_allow_late(900, w)
    assert L.drop().should_allow_late(1000, w)


# ---- windows with injected clock -------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_tumbling_window(P):
    clock = FakeClock()
    w = P.window.TumblingWindow(10.0, clock)
    assert not w.should_trigger()
    clock.t = 10.5
    assert w.should_trigger()
    w.reset()
    assert not w.should_trigger()


def test_sliding_window(P):
    clock = FakeClock()
    w = P.window.SlidingWindow(10.0, 5.0, clock)
    clock.t = 5.1
    assert w.should_trigger()
    assert w.keeps_rows_after_trigger()


def test_session_window(P):
    clock = FakeClock()
    w = P.window.SessionWindow(30.0, clock)
    assert not w.should_trigger()  # no events yet
    w.on_event()
    clock.t = 29.0
    assert not w.should_trigger()
    clock.t = 31.0
    assert w.should_trigger()


# ---- streaming query -------------------------------------------------------
def test_streaming_query_windowed_aggregation(P):
    clock = FakeClock()
    batches = [
        batch(P, {"k": [1, 1, 2], "v": [10, 20, 30]}),
        batch(P, {"k": [2, 2], "v": [40, 50]}),
    ]
    src = P.source.MemoryStreamSource(batches)
    q = query(
        P, src,
        P.stream.StreamConfig(window=P.window.WindowSpec(
            P.window.WindowType.TUMBLING, size_secs=1e9)),
        query="SELECT k, SUM(v) FROM stream GROUP BY k ORDER BY k",
        clock=clock,
    )
    results = q.run()
    assert q.status is P.stream.StreamStatus.COMPLETED
    # window never triggered by time -> flush-on-end emits one result
    assert len(results) == 1
    assert results[0].to_pylist() == [(1, 30), (2, 120)]
    assert q.stats.rows_processed == 5
    assert q.stats.windows_emitted == 1


def test_streaming_channel_source_and_late_drop(P):
    src = P.source.ChannelStreamSource()
    src.send(batch(P, {"ts": [100, 200], "v": [1, 2]}))
    src.send(batch(P, {"ts": [150, 300], "v": [3, 4]}))  # 150 late
    src.close()
    q = query(P, src, P.stream.StreamConfig(event_time_column="ts"),
              query="SELECT COUNT(*) FROM stream")
    results = q.run()
    assert q.stats.late_events_dropped == 1
    assert results[0].to_pylist() == [(3,)]


def test_streaming_checkpoint_restore(P):
    src = P.source.MemoryStreamSource([batch(P, {"ts": [100], "v": [1]})])
    cfg = P.stream.StreamConfig(enable_checkpointing=True,
                                event_time_column="ts")
    q = query(P, src, cfg, query="SELECT COUNT(*) FROM stream")
    q.run(max_batches=1)
    snap = q.checkpoint()
    assert snap is not None and snap["watermark_ms"] == 100

    q2 = query(
        P, P.source.MemoryStreamSource([batch(P, {"ts": [50], "v": [9]})]),
        P.stream.StreamConfig(enable_checkpointing=True,
                              event_time_column="ts"),
        query="SELECT COUNT(*) FROM stream",
    )
    q2.restore(snap)
    q2.run()
    # the 50ms event is late relative to the restored watermark -> dropped
    assert q2.stats.late_events_dropped == 1


# ---- the device table (tests/test_device_stream.py) ------------------------
def batches(P, n_batches=6, rows=100, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        out.append(batch(P, {
            "k": rng.integers(0, 5, rows).tolist(),
            "v": rng.integers(1, 100, rows).tolist(),
            "tag": rng.choice(["x", "y", "z"], rows).tolist(),
        }))
    return out


def test_upload_is_per_batch_not_per_window(P):
    bs = batches(P)
    t = table(P, bs[0].schema, 128)
    total = 0
    for b in bs:
        before = t.upload_rows
        t.append(b)
        total += b.num_rows
        # instrumented transfer grows by exactly the incoming batch
        assert t.upload_rows - before == b.num_rows
    assert t.upload_rows == total
    assert t.num_rows == total
    snap = t.snapshot()
    assert snap.num_rows == total
    # appending after a snapshot never mutates the snapshot
    pre = snap.column("v").to_pylist(snap.num_rows)
    t.append(bs[0])
    assert snap.column("v").to_pylist(snap.num_rows) == pre


def test_capacity_doubles_and_content_matches_concat(P):
    bs = batches(P, n_batches=10, rows=200)
    t = table(P, bs[0].schema, 128)
    for b in bs:
        t.append(b)
    ref = P.Batch.concat(bs)
    snap = t.snapshot()
    assert snap.to_pylist() == ref.to_pylist()
    assert t.capacity >= 2000 and t.capacity & (t.capacity - 1) == 0


def test_dictionary_delta_merge_recodes_resident_rows(P):
    b1 = batch(P, {"s": ["m", "z", "m"]})
    b2 = batch(P, {"s": ["a", "z", "q"]})  # 'a' resorts codes
    t = table(P, b1.schema, 128)
    t.append(b1)
    t.append(b2)
    assert t.dict_merges >= 1
    assert t.snapshot().column("s").to_pylist(6) == [
        "m", "z", "m", "a", "z", "q",
    ]


def test_clear_and_retain(P):
    bs = batches(P, 3, 50)
    t = table(P, bs[0].schema, 128)
    for b in bs:
        t.append(b)
    t.retain_last(50)
    assert t.snapshot().to_pylist() == bs[-1].to_pylist()
    t.clear()
    assert t.num_rows == 0


class TickClock:
    """Advances 1s per call (tests/test_device_stream.py)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def run_stream(P, device, bs):
    src = P.source.MemoryStreamSource(list(bs))
    cfg = P.stream.StreamConfig(
        window=P.window.WindowSpec(P.window.WindowType.TUMBLING,
                                   size_secs=6.0),
        device_buffer=device,
    )
    q = query(
        P, src, cfg,
        query="SELECT k, SUM(v) AS s, COUNT(*) AS c FROM stream "
              "GROUP BY k ORDER BY k",
        clock=TickClock(),
    )
    results = q.run()
    return [r.to_pylist() for r in results], q


def test_windowed_sql_matches_host_path(P):
    bs = batches(P, 6, 80, seed=11)
    dev, qd = run_stream(P, True, bs)
    host, _ = run_stream(P, False, bs)
    assert dev == host
    assert qd._dev_table is not None
    # every ingested row uploaded exactly once
    assert qd._dev_table.upload_rows == sum(b.num_rows for b in bs)


def test_instruments_equal_jax():
    """upload_rows, upload_bytes, appends and dict_merges count the same in
    both tables for the same batches (a merge each time a batch's
    dictionary reorders the resident codes)."""
    got = {}
    for name, P in PKGS.items():
        bs = [batch(P, {"s": s, "v": list(range(len(s)))}) for s in
              (["m", "z"], ["a", "m"], ["a", "m"], ["b", "zz", "c"] * 50)]
        t = table(P, bs[0].schema, 128)
        for b in bs:
            t.append(b)
        got[name] = (t.upload_rows, t.upload_bytes, t.appends,
                     t.dict_merges, t.capacity, t.snapshot().to_pylist())
    assert got["torch"] == got["jax"]
    assert got["jax"][3] == 2


def test_window_results_equal_jax():
    """The same batches through both packages' streams, device buffer on
    and off: the same window results."""
    out = {}
    for name, P in PKGS.items():
        bs = batches(P, 9, 70, seed=5)
        out[name] = (run_stream(P, True, bs)[0], run_stream(P, False, bs)[0])
    assert out["torch"] == out["jax"]
    assert len(out["jax"][0]) > 1


# ---- the port's snapshot guarantee ------------------------------------------
T = PKGS["torch"]


def test_snapshot_survives_append_growth_and_merge():
    b1 = batch(T, {"s": ["m", "z", None], "v": [1.5, None, -2.0]})
    t = table(T, b1.schema, 128)
    t.append(b1)
    snap = t.snapshot()
    want = snap.to_pylist()
    planes0 = [c.data for c in snap.columns]
    dict0 = snap.columns[0].dictionary
    values0 = dict0.values.tolist()
    # a batch whose dictionary reorders the codes ('a' sorts first): the
    # merge recodes the resident plane into a new tensor
    t.append(batch(T, {"s": ["a", "q", "m"], "v": [3.0, 4.0, 5.0]}))
    assert t.dict_merges == 1
    assert t.datas[0] is not planes0[0]
    assert snap.to_pylist() == want
    assert snap.columns[0].dictionary is dict0
    assert dict0.values.tolist() == values0
    # growth past the capacity: new planes, the snapshot's left as they were
    cap = t.capacity
    t.append(batch(T, {"s": ["b"] * 300, "v": [7.0] * 300}))
    assert t.capacity > cap
    assert snap.to_pylist() == want
    assert t.snapshot().to_pylist()[:3] == want
    assert t.snapshot().num_rows == 306


def test_clear_keeps_planes_and_an_append_writes_over_old_snapshots():
    """clear() keeps the planes: rows past num_rows keep their data and
    validity True, as in the JAX table. The next append writes in place at
    row 0 (same addresses, so a window's program replays), over the rows an
    earlier snapshot of those planes holds."""
    rows = {"k": [1, 2, 3], "v": [10, 20, 30]}
    tabs = {}
    for name, P in PKGS.items():
        t = table(P, batch(P, rows).schema, 128)
        t.append(batch(P, rows))
        t.clear()
        tabs[name] = t
        assert t.num_rows == 0
        assert np.asarray(t.valids[1])[:3].tolist() == [True] * 3
        assert np.asarray(t.datas[1])[:3].tolist() == [10, 20, 30]
    t = tabs["torch"]
    old = t.snapshot()
    old.num_rows = 3  # the window before clear()
    ptr = t.datas[1].data_ptr()
    t.append(batch(T, {"k": [9], "v": [90]}))
    assert t.datas[1].data_ptr() == ptr
    # the batch's pad rows are written too (whole capacities, as in JAX)
    assert old.to_pylist() == [(9, 90), (None, None), (None, None)]


def test_clear_then_shorter_window_gives_the_oracle_count():
    """Tumbling windows of 5, 5 and 2 batches over a device table that is
    cleared after each: every window's COUNT(*) and SUM equal numpy over
    exactly its rows, although the shorter last window's planes still hold
    the longer window's rows past num_rows."""
    rng = np.random.default_rng(17)
    vals = [rng.integers(0, 1000, 64) for _ in range(12)]

    class Counter:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Counter()

    class Src(tsource.MemoryStreamSource):
        def next_batch(self, timeout=None):
            b = super().next_batch(timeout)
            if b is not None:
                clock.t += 1
            return b

    src = Src([batch(T, {"v": v.tolist()}) for v in vals])
    q = query(T, src, tstream.StreamConfig(
        window=twindow.WindowSpec(twindow.WindowType.TUMBLING, size_secs=5)),
        query="SELECT COUNT(*) AS n, SUM(v) AS s FROM stream", clock=clock)
    got = [r.to_pylist() for r in q.run()]
    want = [[(len(np.concatenate(vals[a:b])),
              int(np.concatenate(vals[a:b]).sum()))]
            for a, b in ((0, 5), (5, 10), (10, 12))]
    assert got == want
    # the first window grew the planes; the later ones reuse them
    assert q._dev_table.num_rows == 0 and q._dev_table.capacity == 1024


def test_emitted_results_never_change():
    """`SELECT *` returns the scanned planes; the stream copies them out of
    the device table, so a later window's append cannot change them: the
    windows read after the run equal the host-buffered path's."""
    def run(device_buffer):
        bs = [batch(T, {"k": [i, i + 1], "s": [f"a{i}", f"b{i}"]})
              for i in range(6)]
        q = query(T, tsource.MemoryStreamSource(bs), tstream.StreamConfig(
            window=twindow.WindowSpec(twindow.WindowType.TUMBLING,
                                      size_secs=4),
            device_buffer=device_buffer),
            query="SELECT * FROM stream", clock=TickClock())
        return q.run(), q

    results, q = run(True)
    assert len(results) > 1
    assert [r.to_pylist() for r in results] == [
        r.to_pylist() for r in run(False)[0]]
    planes = {p.untyped_storage().data_ptr()
              for p in q._dev_table.datas + q._dev_table.valids}
    for r in results:
        for c in r.columns:
            assert c.data.untyped_storage().data_ptr() not in planes


def test_stream_defaults_to_the_card():
    """With no device argument the stream's Session would lie on the card:
    without CUDA it raises, as Session() does."""
    import torch

    src = tsource.MemoryStreamSource([])
    if torch.cuda.is_available():
        assert tstream.StreamingQuery(src).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tstream.StreamingQuery(src)
