"""Window functions, DISTINCT, set operations and CROSS joins on the card:
captured into CUDA graphs and replayed. Each test skips without a CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_window_cuda.py -m cuda

* the queries of `tpch/windows.py` at 2^13 lineitem rows equal their numpy
  oracles on a first, a replayed and an eager run; no Window, Distinct or
  SetOp node runs as an eager leaf except S3's string set operations;
* every frame kind of `window_aggregate_sorted`, the rank family and the
  positional functions give the CPU's values from a captured graph, for
  int64 and float64 (+-inf) values (float sums within rtol 1e-12: another
  summation order);
* the float prefix sum behind window SUM/AVG gives the same bits on every
  run at 2^23 rows (torch's 1-D float cumsum on CUDA does not);
* `LAG(x, 1)` then `LAG(x, 2)` replay two programs with their own rows.
"""

import gc

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.tpch import data, windows

pytestmark = pytest.mark.cuda

N_LI = 1 << 13


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tables():
    return data.generate(N_LI)


@pytest.mark.parametrize("q", list(windows.QUERIES))
def test_query_replays_equal_to_the_oracle(cuda_device, tables, q):
    s = Session(device="cuda")
    data.register(s, tables)
    want = windows.run(q, tables)
    atol = windows.allowance(q, tables)
    pipe = s.executor.pipeline
    for _ in range(3):  # first run and capture, then replays
        windows.compare(q, s.sql(windows.QUERIES[q]).to_pylist(), want, atol)
    assert pipe.stats["replays"] >= 2, pipe.stats
    leaves = set(pipe.leaf_kinds) & {"Window", "Distinct", "SetOp"}
    assert leaves == ({"SetOp"} if q == "S3" else set()), pipe.leaf_kinds
    s.executor._compiled = False
    windows.compare(q, s.sql(windows.QUERIES[q]).to_pylist(), want, atol)


FRAMES = [("partition",), ("range_current",), ("rows", None, 0),
          ("rows", 2, 1), ("rows", 3, None), ("rows", None, None),
          ("range_off", 2, 1), ("range_off", None, 3), ("range_off", 4, None)]


@pytest.mark.parametrize("frame", FRAMES, ids=str)
@pytest.mark.parametrize("kind", ["i64", "f64"])
def test_frames_in_a_graph_equal_the_cpu(cuda_device, frame, kind):
    cap, n = 1 << 14, (1 << 14) - 37
    rng = np.random.default_rng(len(str(frame)))
    part = np.sort(rng.integers(0, 40, cap))
    key = rng.integers(8000, 8060, cap).astype(np.int32)
    order = np.lexsort((key, part))
    part, key = part[order], key[order]
    pad = np.arange(cap) >= n
    if kind == "i64":
        vals = rng.integers(-1000, 1000, cap) * (1 << 30)
    else:
        vals = rng.integers(-400, 400, cap) / 4.0
        vals[rng.random(cap) < 0.01] = np.inf
    ok = rng.random(cap) > 0.2

    def inputs(dev):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in dict(part=part, key=key, pad=pad, vals=vals,
                                 ok=ok).items()}

    def run(t):
        sc, pc, seg = K.window_segments([t["part"]], [t["key"]], t["pad"])
        plane = K.range_off_order_plane(t["key"], torch.ones_like(t["ok"]),
                                        True, False)
        funcs = ("count", "sum", "avg")
        if not (frame[0] == "range_off" and None not in frame[1:]):
            funcs += ("min", "max")  # not over a bounded RANGE offset
        outs = [K.window_aggregate_sorted(f, t["vals"], t["ok"], sc, pc,
                                          t["pad"], frame, plane)
                for f in funcs]
        every = torch.ones_like(t["ok"])
        outs.append((K.rank_sorted(sc, pc), every))
        outs.append((K.ntile_sorted(sc, 5, t["pad"]), every))
        outs.append(K.shift_in_segment(t["vals"], t["ok"], seg, 3))
        return outs

    want = run(inputs("cpu"))
    t = inputs(cuda_device)
    run(t)  # warm up outside the capture
    graph = torch.cuda.CUDAGraph()
    # no collection may free another test's graph while this one captures
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            got = run(t)
    finally:
        gc.enable()
    live = torch.from_numpy(~pad)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for (gv, gok), (wv, wok) in zip(got, want):
            gv, gok = gv.cpu(), gok.cpu()
            assert torch.equal(gok[live], wok[live])
            m = live & wok
            if gv.is_floating_point():
                # float sums: prefix differences in another summation order
                torch.testing.assert_close(gv[m], wv[m], rtol=1e-12,
                                           atol=1e-6, equal_nan=True)
            else:
                assert torch.equal(gv[m], wv[m])


def test_window_parameters_replay_their_own_programs(cuda_device):
    s = Session(device="cuda")
    s.register_table("m", {"g": [i % 3 for i in range(300)],
                           "x": list(range(300))})
    rows = {}
    for _ in range(2):
        for off in (1, 2):
            q = (f"SELECT x, LAG(x, {off}) OVER (PARTITION BY g ORDER BY x) "
                 "FROM m ORDER BY x")
            got = s.sql(q).to_pylist()
            assert got == rows.setdefault(off, got)
            assert got[10] == (10, 10 - 3 * off)
    assert s.executor.pipeline.stats["compiles"] == 2
    assert s.executor.pipeline.stats["replays"] >= 2


def test_float_prefix_sum_repeats_its_bits(cuda_device):
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1e5, (1 << 23) - 5)
    x[:2] = [np.inf, -np.inf]
    xt = torch.from_numpy(x).to(cuda_device)
    first = K._prefix_sum(xt)
    for _ in range(5):
        assert torch.equal(K._prefix_sum(xt).view(torch.int64),
                           first.view(torch.int64))
    want = torch.cumsum(torch.from_numpy(x[2:]), 0)
    got = K._prefix_sum(xt[2:]).cpu()
    torch.testing.assert_close(got, want, rtol=1e-9, atol=8 * 2.0 ** -53
                               * float(np.abs(x[2:]).sum()))
