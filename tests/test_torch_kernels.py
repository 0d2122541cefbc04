"""Every ported ops/kernels.py function against its JAX twin.

Inputs come from numpy with a fixed seed, with random NULLs and pad rows
(num_rows < capacity), as in tests/test_kernels.py. Results must match
exactly: float values are multiples of 1/4 in a small range, so every sum
is exact in float64 whatever the summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu_torch.ops import kernels as TK

CAP = 256
N = 201  # live rows; rows [N, CAP) are pad rows


def _col(rng, kind, null_frac=0.2, cap=CAP):
    if kind == "i64":
        data = rng.integers(-50, 50, cap)
    elif kind == "i32":
        data = rng.integers(-50, 50, cap).astype(np.int32)
    elif kind == "f64":
        data = rng.integers(-400, 400, cap) / 4.0
    elif kind == "f32":
        data = (rng.integers(-400, 400, cap) / 4.0).astype(np.float32)
    elif kind == "bool":
        data = rng.random(cap) < 0.5
    else:
        raise ValueError(kind)
    valid = rng.random(cap) >= null_frac
    return data, valid


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref):
    """Exact equality of a torch result with a JAX result (values, not
    index dtypes: the port's index planes are int64)."""
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if r.dtype.kind == "f" or p.dtype.kind == "f":
        np.testing.assert_array_equal(p.astype(np.float64),
                                      r.astype(np.float64))
    else:
        np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


KINDS = ["i64", "i32", "f64", "f32", "bool"]


@pytest.mark.parametrize("num_rows", [0, N, CAP])
def test_masks_and_compaction(num_rows):
    rng = np.random.default_rng(num_rows)
    mask = rng.random(CAP) < 0.4
    _eq(TK.live_mask(CAP, num_rows), JK.live_mask(CAP, num_rows))
    _eq(TK.filter_count(_t(mask), num_rows), JK.filter_count(_j(mask),
                                                            num_rows))
    for out_cap in (128, 256):
        _eq(TK.compaction_indices(_t(mask), num_rows, out_cap),
            JK.compaction_indices(_j(mask), num_rows, out_cap))
    sel = _t(mask)
    assert TK.live_mask(CAP, sel) is sel  # an explicit mask passes through


def test_gather_columns():
    rng = np.random.default_rng(1)
    cols = [_col(rng, k) for k in KINDS]
    idx = rng.integers(0, CAP, 128)
    row_valid = rng.random(128) < 0.7
    for rv in (None, row_valid):
        pd, pv = TK.gather_columns([_t(d) for d, _ in cols],
                                   [_t(v) for _, v in cols], _t(idx),
                                   None if rv is None else _t(rv))
        jd, jv = JK.gather_columns([_j(d) for d, _ in cols],
                                   [_j(v) for _, v in cols], _j(idx),
                                   None if rv is None else _j(rv))
        for a, b in zip(pd + pv, jd + jv):
            _eq(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_orderable_and_normalize_key(kind):
    rng = np.random.default_rng(2)
    d, v = _col(rng, kind)
    _eq(TK.orderable_i64(_t(d)), JK.orderable_i64(_j(d)))
    pk, pn = TK.normalize_key(_t(d), _t(v))
    jk, jn = JK.normalize_key(_j(d), _j(v))
    _eq(pk, jk)
    _eq(pn, jn)
    if kind in ("f32",):
        y = TK.orderable_i64(_t(d))
        _eq(TK.from_orderable(y, torch.float32), d)


@pytest.mark.parametrize("kinds,ascs,nfs", [
    (["i64"], [True], [False]),
    (["i64"], [False], [True]),
    (["f64", "i32"], [False, True], [False, True]),
    (["i32", "f64", "bool"], [True, False, True], [True, False, False]),
    (["f32", "i64"], [False, False], [True, True]),
])
def test_sort_permutation(kinds, ascs, nfs):
    """DESC, NULLS FIRST/LAST, several keys; few distinct values, so many
    ties check stability (ties keep input order)."""
    rng = np.random.default_rng(len(kinds))
    cols = []
    for k in kinds:
        d, v = _col(rng, k)
        if k in ("i64", "i32"):
            d = (d % 4).astype(d.dtype)  # many ties
        cols.append((d, v))
    pad = ~np.asarray(JK.live_mask(CAP, N))
    p_ops = TK._sort_key_operands([_t(d) for d, _ in cols],
                                  [_t(v) for _, v in cols], ascs, nfs,
                                  _t(pad))
    j_ops = JK._sort_key_operands([_j(d) for d, _ in cols],
                                  [_j(v) for _, v in cols], ascs, nfs,
                                  _j(pad))
    assert len(p_ops) == len(j_ops)
    for a, b in zip(p_ops, j_ops):
        _eq(a, b)
    perm = TK.sort_permutation([_t(d) for d, _ in cols],
                               [_t(v) for _, v in cols], ascs, nfs, N)
    ref = JK.sort_permutation([_j(d) for d, _ in cols],
                              [_j(v) for _, v in cols], ascs, nfs, N)
    _eq(perm, ref)
    # stability: within equal keys, rows keep ascending input order
    live = perm.numpy()[:N]
    keys = [tuple((bool(v[i]), d[i] if v[i] else 0) for d, v in cols)
            for i in live]
    for a, b, ka, kb in zip(live, live[1:], keys, keys[1:]):
        if ka == kb:
            assert a < b


@pytest.mark.parametrize("kind", ["i64", "i32", "bool"])
def test_key_range_and_group_ids_direct(kind):
    rng = np.random.default_rng(3)
    d, v = _col(rng, kind)
    if kind == "bool":
        d = d.astype(np.int32)
    for a, b in zip(TK.key_range(_t(d), _t(v), N),
                    JK.key_range(_j(d), _j(v), N)):
        _eq(a, b)
    lo, hi = int(d[:N][v[:N]].min()), int(d[:N][v[:N]].max())
    for got, ref in zip(
        TK.group_ids_direct(_t(d), _t(v), N, lo, hi - lo + 1),
        JK.group_ids_direct(_j(d), _j(v), N, lo, hi - lo + 1),
    ):
        _eq(got, ref)


def test_group_ids_direct_all_null():
    d = np.zeros(CAP, np.int64)
    v = np.zeros(CAP, bool)
    for got, ref in zip(TK.group_ids_direct(_t(d), _t(v), N, 0, 4),
                        JK.group_ids_direct(_j(d), _j(v), N, 0, 4)):
        _eq(got, ref)


@pytest.mark.parametrize("kinds", [["i64"], ["i32", "f64"],
                                   ["f32", "bool", "i64"]])
def test_group_ids(kinds):
    rng = np.random.default_rng(4)
    cols = []
    for k in kinds:
        d, v = _col(rng, k)
        if k in ("i64", "i32"):
            d = (d % 5).astype(d.dtype)
        cols.append((d, v))
    got = TK.group_ids([_t(d) for d, _ in cols], [_t(v) for _, v in cols], N)
    ref = JK.group_ids([_j(d) for d, _ in cols], [_j(v) for _, v in cols], N)
    ng = int(ref[1])
    _eq(got[0][:N], ref[0][:N])  # pad rows' ids are unspecified
    _eq(got[1], ref[1])
    _eq(got[2][:ng], ref[2][:ng])


@pytest.mark.parametrize("ascs,nfs", [
    ([True, True], [False, False]),
    ([False, True], [True, False]),
    ([False, False], [False, True]),
])
@pytest.mark.parametrize("num_rows", [N, "mask"])
def test_composite_key_sort_and_group_ids(ascs, nfs, num_rows):
    """Keys with static (lo, range) covers compose into one int64 operand
    (the compiled pipeline's `ranges`); the covers include values outside
    the live data, as table-stat covers do."""
    rng = np.random.default_rng(8)
    cols = [_col(rng, "i64"), _col(rng, "i32")]
    cols = [((d % 7).astype(d.dtype), v) for d, v in cols]
    ranges = [(-8, 16), (-8, 128)]
    if num_rows == "mask":
        num_rows = rng.random(CAP) < 0.6
    tn = _t(num_rows) if isinstance(num_rows, np.ndarray) else num_rows
    jn = _j(num_rows) if isinstance(num_rows, np.ndarray) else num_rows
    td, tv = [_t(d) for d, _ in cols], [_t(v) for _, v in cols]
    jd, jv = [_j(d) for d, _ in cols], [_j(v) for _, v in cols]
    _eq(TK.sort_permutation(td, tv, ascs, nfs, tn, ranges=ranges),
        JK.sort_permutation(jd, jv, ascs, nfs, jn, ranges=ranges))
    # the live rows in the order of the operand-per-key sort (pad rows
    # sink to the end in an unspecified order)
    live = np.asarray(JK.live_mask(CAP, jn))
    n_live = int(live.sum())
    _eq(TK.sort_permutation(td, tv, ascs, nfs, tn, ranges=ranges)[:n_live],
        TK.sort_permutation(td, tv, ascs, nfs, tn)[:n_live])
    got = TK.group_ids(td, tv, tn, ranges=ranges)
    ref = JK.group_ids(jd, jv, jn, ranges=ranges)
    ng = int(ref[1])
    _eq(got[0][_t(live)], np.asarray(ref[0])[live])  # pad ids unspecified
    _eq(got[1], ref[1])
    _eq(got[2][:ng], ref[2][:ng])


@pytest.mark.parametrize("func", ["count_star", "count", "sum", "avg",
                                  "min", "max"])
@pytest.mark.parametrize("kind", ["i64", "i32", "f64", "f32"])
def test_segment_aggregate(func, kind):
    rng = np.random.default_rng(5)
    d, v = _col(rng, kind)
    gid = rng.integers(0, 9, CAP)
    gid[gid == 4] = 3  # group 4 stays empty
    pv, pok = TK.segment_aggregate(func, _t(d), _t(v), _t(gid), N, 9)
    jv, jok = JK.segment_aggregate(func, _j(d), _j(v), _j(gid), N, 9)
    _eq(pok, jok)
    ok = np.asarray(jok)
    _eq(pv.numpy()[ok], np.asarray(jv)[ok])  # empty groups: unspecified


@pytest.mark.parametrize("func", ["count_star", "count", "sum", "avg",
                                  "min", "max"])
@pytest.mark.parametrize("kind", ["i64", "f64"])
@pytest.mark.parametrize("num_rows", [0, N])
def test_global_aggregate(func, kind, num_rows):
    rng = np.random.default_rng(6)
    d, v = _col(rng, kind)
    pv, pok = TK.global_aggregate(func, _t(d), _t(v), num_rows)
    jv, jok = JK.global_aggregate(func, _j(d), _j(v), num_rows)
    _eq(pok, jok)
    if bool(jok[0]):
        _eq(pv[:1], jv[:1])


@pytest.mark.parametrize("lkinds,rkinds", [
    (["i64"], ["i64"]),
    (["i32"], ["i64"]),
    (["i64", "i32"], ["i64", "i32"]),
    (["f64"], ["f64"]),
])
def test_join_pipeline(lkinds, rkinds):
    """join_ranks -> join_counts -> join_emit_inner -> unmatched_indices:
    duplicates on both sides, NULL keys (never match), pad rows."""
    rng = np.random.default_rng(len(lkinds) + 10 * len(rkinds[0]))
    cap_l, n_l, cap_r, n_r = 256, 230, 128, 90
    lk, rk = [], []
    for lk_kind, rk_kind in zip(lkinds, rkinds):
        ld, lv = _col(rng, lk_kind, 0.1, cap_l)
        rd, rv = _col(rng, rk_kind, 0.1, cap_r)
        ld = (ld % 7).astype(ld.dtype)
        rd = (rd % 9).astype(rd.dtype)
        lk.append((ld, lv))
        rk.append((rd, rv))
    p_lr, p_rr = TK.join_ranks([(_t(d), _t(v)) for d, v in lk],
                               [(_t(d), _t(v)) for d, v in rk], n_l, n_r)
    j_lr, j_rr = JK.join_ranks([(_j(d), _j(v)) for d, v in lk],
                               [(_j(d), _j(v)) for d, v in rk], n_l, n_r)
    _eq(p_lr, j_lr)
    _eq(p_rr, j_rr)
    p_c = TK.join_counts(p_lr, p_rr, n_l, n_r)
    j_c = JK.join_counts(j_lr, j_rr, n_l, n_r)
    for a, b in zip(p_c, j_c):
        _eq(a, b)
    total = int(j_c[0])
    assert total > 0
    out_cap = 1 << max(int(total - 1).bit_length(), 7)
    p_e = TK.join_emit_inner(p_c[1], p_c[3], p_c[4], p_lr, total, out_cap)
    j_e = JK.join_emit_inner(j_c[1], j_c[3], j_c[4], j_lr, total, out_cap)
    for a, b in zip(p_e, j_e):
        _eq(a, b)
    for matched, n, cap in ((p_c[5], n_l, cap_l), (p_c[6], n_r, cap_r)):
        got = TK.unmatched_indices(matched, n, cap)
        ref = JK.unmatched_indices(_j(matched.numpy()), n, cap)
        for a, b in zip(got, ref):
            _eq(a, b)
