"""The port's window family and CROSS index planes (ops/kernels.py) against
their JAX twins in `query_engine_tpu.ops.kernels`.

Inputs are seeded numpy planes put in window order the way the executors
put them (partition keys, then the ORDER BY key with its NULLs first or
last, pad rows at the end), with NULLs, pad rows and heavy ties. Every
frame kind meets COUNT(*), COUNT, SUM, AVG, MIN and MAX over int32, int64,
float32 and float64 values (the floats with +-inf, and NaN of either sign
for MIN/MAX); RANGE offset frames run over int32, int64 and float64 keys,
ASC and DESC, NULLs first and last. Float values are multiples of 1/4 in a
small range, so every prefix sum is exact and results must match bit for
bit (NaN where +inf meets -inf).
Also the row scans that replace torch's 1-D scans on the card (`_row_scan`,
`_cummax`) against torch.cumsum and torch.cummax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.core.errors import ExecutionError as JExecutionError
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.ops import kernels as TK

CAP = 256
N = 203  # live rows; rows [N, CAP) are pad rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref, where=None):
    """Exact equality (NaN equal to NaN) of a port plane and a JAX plane,
    optionally only where `where` holds."""
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if where is not None:
        p, r = p[where], r[where]
    if r.dtype.kind == "f" or p.dtype.kind == "f":
        np.testing.assert_array_equal(p.astype(np.float64),
                                      r.astype(np.float64))
    else:
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


def _values(rng, kind, n=CAP, nan=False):
    """Seeded values of `kind`; floats hold +-inf, and with `nan` also NaN
    and -NaN (a running MIN/MAX passes NaN on over 64-bit floats and ranks
    it by its orderable image over float32, as the JAX package does)."""
    if kind == "i32":
        return rng.integers(-60, 60, n).astype(np.int32)
    if kind == "i64":
        return rng.integers(-60, 60, n) * (1 << 33)
    x = rng.integers(-400, 400, n) / 4.0
    x[rng.random(n) < 0.04] = np.inf
    x[rng.random(n) < 0.04] = -np.inf
    if nan:
        x[rng.random(n) < 0.02] = np.nan
        x[rng.random(n) < 0.02] = -np.nan
    return x.astype(np.float32) if kind == "f32" else x


def _window_order(rng, key_kind="i32", asc=True, nulls_first=False,
                  n_parts=5):
    """Planes in window order: partition key, ORDER BY key (heavy ties)
    and its validity, the pad flag, and the segment inputs as the
    executors build them (normalized [null, key] planes)."""
    part = rng.integers(0, n_parts, CAP)
    if key_kind == "f64":
        key = rng.integers(-12, 12, CAP) * 0.5
    elif key_kind == "i64":
        key = rng.integers(-12, 12, CAP) * (1 << 31)
    else:
        key = rng.integers(8000, 8030, CAP).astype(np.int32)  # dates
    kok = rng.random(CAP) > 0.1
    live = np.arange(CAP) < N
    ord_key = key.astype(np.float64) if asc else -key.astype(np.float64)
    null_cls = np.where(kok, 1, 0) if nulls_first else np.where(kok, 0, 1)
    perm = np.lexsort((np.where(kok, ord_key, 0), null_cls, part, ~live))
    part, key, kok = part[perm], key[perm], kok[perm]
    pad = ~live[perm]
    kz = np.where(kok, key, 0).astype(key.dtype)
    return {
        "part": part, "key": key, "kok": kok, "pad": pad,
        "part_planes": [part], "order_planes": [(~kok).astype(np.int32), kz],
        "asc": asc, "nulls_first": nulls_first,
    }


def _segments(w):
    j = JK.window_segments([jnp.asarray(p) for p in w["part_planes"]],
                           [jnp.asarray(p) for p in w["order_planes"]],
                           jnp.asarray(w["pad"]))
    t = TK.window_segments([_t(p) for p in w["part_planes"]],
                           [_t(p) for p in w["order_planes"]], _t(w["pad"]))
    return j, t


def _order_planes(w):
    """(JAX, port) range-offset order planes (key, key valid)."""
    j = JK.range_off_order_plane(jnp.asarray(w["key"]), jnp.asarray(w["kok"]),
                                 w["asc"], w["nulls_first"])
    t = TK.range_off_order_plane(_t(w["key"]), _t(w["kok"]), w["asc"],
                                 w["nulls_first"])
    return j, t


@pytest.mark.parametrize("seed", range(3))
def test_segments_and_rank_family(seed):
    rng = np.random.default_rng(seed)
    w = _window_order(rng)
    (jsc, jpc, jseg), (tsc, tpc, tseg) = _segments(w)
    _eq(tsc, jsc)
    _eq(tpc, jpc)
    _eq(tseg, jseg)
    _eq(TK.row_number_sorted(tsc), JK.row_number_sorted(jsc))
    _eq(TK.rank_sorted(tsc, tpc), JK.rank_sorted(jsc, jpc))
    _eq(TK.dense_rank_sorted(tsc, tpc), JK.dense_rank_sorted(jsc, jpc))
    _eq(TK.percent_rank_sorted(tsc, tpc), JK.percent_rank_sorted(jsc, jpc))
    _eq(TK.cume_dist_sorted(tsc, tpc), JK.cume_dist_sorted(jsc, jpc))


@pytest.mark.parametrize("n_tiles", [1, 3, 7, 64, 300])
def test_ntile(n_tiles):
    """300 tiles: more tiles than any partition has rows."""
    rng = np.random.default_rng(n_tiles)
    w = _window_order(rng, n_parts=4)
    (jsc, _, _), (tsc, _, _) = _segments(w)
    _eq(TK.ntile_sorted(tsc, n_tiles, _t(w["pad"])),
        JK.ntile_sorted(jsc, n_tiles, jnp.asarray(w["pad"])))


@pytest.mark.parametrize("offset", [1, 2, 5, -1, -3, 40, -40, 300])
@pytest.mark.parametrize("kind", ["i32", "i64", "f64"])
def test_shift_in_segment(offset, kind):
    """LAG (offset > 0) and LEAD (< 0), beyond the segment too."""
    rng = np.random.default_rng(abs(offset))
    w = _window_order(rng, n_parts=6)
    (_, _, jseg), (_, _, tseg) = _segments(w)
    vals = _values(rng, kind)
    valid = rng.random(CAP) > 0.2
    jv, jok = JK.shift_in_segment(jnp.asarray(vals), jnp.asarray(valid), jseg,
                                  offset)
    tv, tok = TK.shift_in_segment(_t(vals), _t(valid), tseg, offset)
    _eq(tok, jok)
    _eq(tv, jv, np.asarray(jok))


def test_value_at_and_cross_join_indices():
    rng = np.random.default_rng(11)
    vals = _values(rng, "f64")
    valid = rng.random(CAP) > 0.2
    pos = rng.integers(-5, CAP + 5, CAP)
    jv, jok = JK.value_at(jnp.asarray(vals), jnp.asarray(valid),
                          jnp.asarray(pos))
    tv, tok = TK.value_at(_t(vals), _t(valid), _t(pos))
    _eq(tv, jv)
    _eq(tok, jok)
    for nl, nr, cap in [(5, 7, 128), (0, 3, 128), (4, 0, 128), (40, 9, 512)]:
        for a, b in zip(TK.cross_join_indices(nl, nr, cap),
                        JK.cross_join_indices(nl, nr, cap)):
            _eq(a, b)


@pytest.mark.parametrize("key_kind", ["i32", "i64", "f64"])
@pytest.mark.parametrize("asc,nulls_first", [(True, False), (True, True),
                                             (False, False), (False, True)])
def test_range_off_order_plane(key_kind, asc, nulls_first):
    rng = np.random.default_rng(3)
    w = _window_order(rng, key_kind, asc, nulls_first)
    (jk, jok), (tk, tok) = _order_planes(w)
    _eq(tk, jk)
    _eq(tok, jok)


FRAMES = [
    ("partition",), ("range_current",),
    ("rows", None, 0), ("rows", 2, 0), ("rows", 1, 2), ("rows", 0, 0),
    ("rows", 0, None), ("rows", 3, None), ("rows", None, None),
    ("rows", None, 2), ("rows", 4, 1),
    ("range_off", 2, 1), ("range_off", None, 3), ("range_off", 4, None),
    ("range_off", 0, 0), ("range_off", None, None),
]


@pytest.mark.parametrize("frame", FRAMES, ids=str)
@pytest.mark.parametrize("key_kind,asc,nulls_first", [
    ("i32", True, False), ("i64", False, True), ("f64", False, False),
    ("f64", True, True)])
def test_window_frame_bounds(frame, key_kind, asc, nulls_first):
    rng = np.random.default_rng(len(str(frame)))
    w = _window_order(rng, key_kind, asc, nulls_first)
    (jsc, jpc, _), (tsc, tpc, _) = _segments(w)
    jop, top = _order_planes(w) if frame[0] == "range_off" else (None, None)
    jlo, jhi = JK.window_frame_bounds(frame, jsc, jpc, jnp.asarray(w["pad"]),
                                      jop)
    tlo, thi = TK.window_frame_bounds(frame, tsc, tpc, _t(w["pad"]), top)
    live = ~w["pad"]
    _eq(tlo, jlo, live)
    _eq(thi, jhi, live)


FUNCS = ["count_star", "count", "sum", "avg", "min", "max"]


def _bounded_range_min_max(func, frame):
    return (func in ("min", "max") and frame[0] == "range_off"
            and frame[1] is not None and frame[2] is not None)


@pytest.mark.parametrize("kind", ["i32", "i64", "f32", "f64"])
@pytest.mark.parametrize("func", FUNCS)
@pytest.mark.parametrize("frame", FRAMES, ids=str)
def test_window_aggregate_sorted(frame, func, kind):
    """Every frame kind x aggregate x value type, with a date-like int32
    ORDER BY key (ASC, NULLs last) for the RANGE offset frames; MIN/MAX
    over a bounded RANGE offset frame raises in both. MIN/MAX values hold
    NaN too."""
    rng = np.random.default_rng(FUNCS.index(func) * 31 + len(str(frame)))
    w = _window_order(rng, "i32", True, False)
    (jsc, jpc, _), (tsc, tpc, _) = _segments(w)
    jop, top = _order_planes(w) if frame[0] == "range_off" else (None, None)
    vals = _values(rng, kind, nan=func in ("min", "max"))
    valid = rng.random(CAP) > 0.25
    jargs = (None, None) if func == "count_star" else (jnp.asarray(vals),
                                                        jnp.asarray(valid))
    targs = (None, None) if func == "count_star" else (_t(vals), _t(valid))
    pad = w["pad"]
    if _bounded_range_min_max(func, frame):
        with pytest.raises(JExecutionError):
            JK.window_aggregate_sorted(func, *jargs, jsc, jpc,
                                       jnp.asarray(pad), frame, jop)
        with pytest.raises(ExecutionError):
            TK.window_aggregate_sorted(func, *targs, tsc, tpc, _t(pad),
                                       frame, top)
        return
    jv, jok = JK.window_aggregate_sorted(func, *jargs, jsc, jpc,
                                         jnp.asarray(pad), frame, jop)
    tv, tok = TK.window_aggregate_sorted(func, *targs, tsc, tpc, _t(pad),
                                         frame, top)
    live = ~pad
    _eq(tok, jok, live)
    _eq(tv, jv, live & np.asarray(jok))


@pytest.mark.parametrize("frame", [f for f in FRAMES if f[0] == "range_off"],
                         ids=str)
@pytest.mark.parametrize("key_kind,asc,nulls_first", [
    ("i64", True, True), ("i64", False, False), ("f64", False, True),
    ("f64", True, False), ("i32", False, True)])
def test_range_offset_sum_count(frame, key_kind, asc, nulls_first):
    """RANGE offsets over int64 and float64 keys, ASC and DESC, NULL keys
    first and last (a NULL key frames its NULL peer group)."""
    rng = np.random.default_rng(7)
    w = _window_order(rng, key_kind, asc, nulls_first)
    (jsc, jpc, _), (tsc, tpc, _) = _segments(w)
    jop, top = _order_planes(w)
    vals = _values(rng, "f64")
    valid = rng.random(CAP) > 0.25
    live = ~w["pad"]
    for func in ("count", "sum"):
        jv, jok = JK.window_aggregate_sorted(
            func, jnp.asarray(vals), jnp.asarray(valid), jsc, jpc,
            jnp.asarray(w["pad"]), frame, jop)
        tv, tok = TK.window_aggregate_sorted(
            func, _t(vals), _t(valid), tsc, tpc, _t(w["pad"]), frame, top)
        _eq(tok, jok, live)
        _eq(tv, jv, live & np.asarray(jok))


@pytest.mark.parametrize("kind", ["i32", "i64", "f32", "f64"])
@pytest.mark.parametrize("is_min", [True, False])
def test_segment_running_extreme(kind, is_min):
    """The running MIN/MAX, 64-bit values, +-inf and NaN of either sign
    included, bit for bit; the neutral element before a segment's first
    valid row."""
    rng = np.random.default_rng(5)
    w = _window_order(rng, n_parts=9)
    (jsc, _, _), (tsc, _, _) = _segments(w)
    vals = _values(rng, kind, nan=True)
    ok = (rng.random(CAP) > 0.3) & ~w["pad"]
    _eq(TK._segment_running_extreme(_t(vals), _t(ok), tsc, is_min),
        JK._segment_running_extreme(jnp.asarray(vals), jnp.asarray(ok), jsc,
                                    is_min))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 4097, 20000])
@pytest.mark.parametrize("row", [4, 64, 4096])
def test_row_scan_is_a_prefix_sum(n, row):
    """The fixed-order float prefix sum the card's window sums take:
    equal to torch.cumsum on sums that are exact in any order (multiples
    of 1/4, +-inf), and within float64 rounding on others."""
    rng = np.random.default_rng(n + row)
    x = _t(rng.integers(-400, 400, n) / 4.0)
    if n > 2:
        x[n // 2] = np.inf
    assert torch.equal(TK._row_scan(x, row), torch.cumsum(x, 0))
    y = _t(rng.normal(0.0, 1e5, n))
    torch.testing.assert_close(TK._row_scan(y, row), torch.cumsum(y, 0),
                               rtol=1e-12, atol=1e-6)


@pytest.mark.parametrize("first", [True, False])
def test_segment_positions(first):
    """The first and last row of each row's run, also before the first
    flag (0, and the row before it)."""
    rng = np.random.default_rng(int(first))
    flags = rng.random(CAP) < 0.1
    flags[0] = first
    _eq(TK._seg_start_pos(_t(flags)), JK._seg_start_pos(jnp.asarray(flags)))
    _eq(TK._seg_end_pos(_t(flags)), JK._seg_end_pos(jnp.asarray(flags)))


@pytest.mark.parametrize("n", [1, 5, 64, 65, 1000, 4099])
@pytest.mark.parametrize("row", [4, 64, 1024])
def test_cummax_rows(n, row):
    rng = np.random.default_rng(n * row)
    x = _t(rng.integers(-(1 << 62), 1 << 62, n))
    assert torch.equal(TK._cummax(x, row), torch.cummax(x, 0).values)
