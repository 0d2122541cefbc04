"""The small-table gather and the FK join kernels against their JAX twins.

The small gather's plain versions (what the port runs on the CPU), of both
forms, against the JAX package's `mxu_gather_words`, whose Pallas kernel
runs in interpret mode on the CPU, as tests/test_pallas_kernels.py runs it:
bit-exact, with indices of -1, T and far out of range. Then
`gather_columns_packed` (both routes), `fk_gather_by_rank`,
`fk_join_right_lookup` and the segment position helpers against the JAX
functions on the same numpy inputs: results must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu.ops.pallas.small_gather import mxu_gather_words
from query_engine_tpu_torch.ops import kernels as TK
from query_engine_tpu_torch.ops import small_gather


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    np.testing.assert_array_equal(p.astype(np.float64 if p.dtype.kind == "f"
                                           else np.int64),
                                  r.astype(np.float64 if r.dtype.kind == "f"
                                           else np.int64))


@pytest.mark.parametrize("T", [1, 300, 4096])
@pytest.mark.parametrize("W", [1, 3])
def test_gather_words_plain_matches_jax_kernel(T, W):
    rng = np.random.default_rng(T * 10 + W)
    table = rng.integers(0, 2**32, (T, W), dtype=np.uint64).astype(np.uint32)
    n = 3000
    idx = rng.integers(0, T, n).astype(np.int32)
    idx[rng.random(n) < 0.2] = -1  # unmatched rows
    idx[:6] = [-1, T, T + 1, 2**31 - 1, -(2**31), T - 1]
    want = np.asarray(mxu_gather_words(jnp.asarray(idx), jnp.asarray(table),
                                       W))
    bits = small_gather.to_bits(_t(table.astype(np.int64)))
    got = small_gather.gather_words(_t(idx), bits)
    assert got.dtype == torch.int32 and got.shape == (n, W)
    np.testing.assert_array_equal(small_gather.from_bits(got).numpy(),
                                  want.astype(np.int64))
    # zero rows exactly where the index is out of range
    out_of_range = (idx < 0) | (idx >= T)
    assert (got.numpy()[out_of_range] == 0).all()


@pytest.mark.parametrize("T", [1, 300, 4096])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_gather_word_planes_plain_matches_jax_kernel(T, W):
    """The join's form (int64 indices, int64 planes [W, T], planes out)
    against the Pallas kernel, exact. JAX casts indices to int32, so it
    is given -1 where an int64 index lies outside the int32 range; the
    port's contract zeroes every index outside [0, T)."""
    rng = np.random.default_rng(T * 10 + W + 1)
    table = rng.integers(0, 2**32, (T, W), dtype=np.uint64).astype(np.uint32)
    n = 3000
    idx = rng.integers(0, T, n)
    idx[rng.random(n) < 0.2] = -1
    idx[:8] = [-1, T, T + 1, 2**40, -(2**40), 2**31, -(2**31) - 1, T - 1]
    in_i32 = (idx >= -(2**31)) & (idx < 2**31)
    want = np.asarray(mxu_gather_words(
        jnp.asarray(np.where(in_i32, idx, -1).astype(np.int32)),
        jnp.asarray(table), W))
    planes = _t(table.T.astype(np.int64))
    got = small_gather.gather_word_planes(_t(idx), planes)
    assert got.dtype == torch.int64 and got.shape == (W, n)
    np.testing.assert_array_equal(got.numpy(), want.T.astype(np.int64))
    assert (got.numpy()[:, (idx < 0) | (idx >= T)] == 0).all()
    # bits above the low 32 of a plane value are not gathered
    high = small_gather.gather_word_planes(_t(idx), planes | (7 << 40))
    assert torch.equal(high, got)


def test_gather_word_planes_checks_dtypes():
    with pytest.raises(ValueError):  # int32 indices: the join's are int64
        small_gather.gather_word_planes(torch.zeros(4, dtype=torch.int32),
                                        torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError):
        small_gather.gather_word_planes(torch.zeros(4, dtype=torch.int64),
                                        torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        small_gather.gather_word_planes_kernel(
            torch.zeros(4, dtype=torch.int64),
            torch.zeros((1, 2), dtype=torch.int64))


def test_word_bit_patterns_round_trip():
    words = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=np.int64)
    bits = small_gather.to_bits(_t(words))
    assert bits.dtype == torch.int32
    assert bits.tolist() == [0, 1, 2**31 - 1, -(2**31), -1]
    assert small_gather.from_bits(bits).tolist() == words.tolist()


def test_gather_words_checks_dtypes():
    with pytest.raises(ValueError):
        small_gather.gather_words(torch.zeros(4, dtype=torch.int64),
                                  torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        small_gather.gather_words_kernel(torch.zeros(4, dtype=torch.int32),
                                         torch.zeros((2, 1),
                                                     dtype=torch.int32))


def _build_side(rng, cap, n_live):
    """A dimension-like build side: a unique int key, a bounded int, a
    bool, a float (does not pack) and an unbounded int64."""
    key = rng.permutation(cap).astype(np.int64)
    cols = [
        (key, np.arange(cap) < n_live, (0, cap)),
        (rng.integers(-40, 40, cap), rng.random(cap) > 0.2, (-128, 128)),
        (rng.random(cap) < 0.5, rng.random(cap) > 0.1, None),
        (rng.integers(-400, 400, cap) / 4.0, rng.random(cap) > 0.1, None),
        (rng.integers(-2**40, 2**40, cap), rng.random(cap) > 0.1, None),
    ]
    return cols


@pytest.mark.parametrize("mxu_small", [False, True])
@pytest.mark.parametrize("which", ["packable", "all"])
def test_gather_columns_packed_matches_jax(mxu_small, which):
    rng = np.random.default_rng(11)
    cap = 256
    cols = _build_side(rng, cap, 200)
    if which == "packable":
        cols = cols[:3]
    n = 1024
    idx = rng.integers(0, cap, n)
    row_valid = rng.random(n) < 0.8
    datas = [c[0] for c in cols]
    valids = [c[1] for c in cols]
    bounds = [c[2] for c in cols]
    for rv in (None, row_valid):
        pd, pv = TK.gather_columns_packed(
            [_t(d) for d in datas], [_t(v) for v in valids], bounds, _t(idx),
            None if rv is None else _t(rv), mxu_small=mxu_small,
        )
        jd, jv = JK.gather_columns_packed(
            [jnp.asarray(d) for d in datas], [jnp.asarray(v) for v in valids],
            bounds, jnp.asarray(idx), None if rv is None else jnp.asarray(rv),
            mxu_small=mxu_small,
        )
        for a, b, d in zip(pd, jd, datas):
            assert a.dtype == _t(d).dtype
            _eq(a, b)
        for a, b in zip(pv, jv):
            _eq(a, b)


def test_packed_route_is_one_word_plane_gather(monkeypatch):
    """mxu_small: one gather_word_planes call over all the packed planes,
    and no int32 conversion pass (to_bits / from_bits) around it."""
    rng = np.random.default_rng(12)
    cap = 256
    cols = _build_side(rng, cap, 200)
    calls = []
    real = small_gather.gather_word_planes

    def counted(idx, planes):
        calls.append((idx.dtype, tuple(planes.shape)))
        return real(idx, planes)

    def refused(*args):
        raise AssertionError("a bit-pattern conversion on the packed route")

    monkeypatch.setattr(small_gather, "gather_word_planes", counted)
    monkeypatch.setattr(small_gather, "to_bits", refused)
    monkeypatch.setattr(small_gather, "from_bits", refused)
    idx = _t(rng.integers(0, cap, 1024))
    TK.gather_columns_packed([_t(c[0]) for c in cols],
                             [_t(c[1]) for c in cols], [c[2] for c in cols],
                             idx, mxu_small=True)
    (call,) = calls
    assert call[0] == torch.int64 and call[1][1] == cap


def _ranks(rng, cap_l, cap_r, n_l, n_r, n_ranks):
    """Probe ranks (any rank, or negative for NULL keys) and unique build
    ranks; pad rows beyond n_l / n_r."""
    lr = rng.integers(0, n_ranks, cap_l)
    lr[rng.random(cap_l) < 0.1] = -5
    rr = rng.permutation(n_ranks)[:cap_r] if cap_r <= n_ranks else \
        rng.integers(0, n_ranks, cap_r)
    rr = rr.astype(np.int64)
    rr[rng.random(cap_r) < 0.1] = -7
    return lr.astype(np.int64), rr


@pytest.mark.parametrize("n_ranks", [300, None])
def test_fk_join_right_lookup_matches_jax(n_ranks):
    rng = np.random.default_rng(5)
    cap_l, cap_r = 512, 256
    lr, rr = _ranks(rng, cap_l, cap_r, 500, 200, n_ranks or cap_l + cap_r)
    for n_l, n_r in ((500, 200), (cap_l, cap_r)):
        pi, pm = TK.fk_join_right_lookup(_t(lr), _t(rr), n_l, n_r, n_ranks)
        ji, jm = JK.fk_join_right_lookup(jnp.asarray(lr), jnp.asarray(rr),
                                         n_l, n_r, n_ranks)
        _eq(pi, ji)
        _eq(pm, jm)
    # a selection mask in place of a row count
    sel_l = rng.random(cap_l) < 0.7
    sel_r = rng.random(cap_r) < 0.9
    pi, pm = TK.fk_join_right_lookup(_t(lr), _t(rr), _t(sel_l), _t(sel_r),
                                     n_ranks)
    ji, jm = JK.fk_join_right_lookup(jnp.asarray(lr), jnp.asarray(rr),
                                     jnp.asarray(sel_l), jnp.asarray(sel_r),
                                     n_ranks)
    _eq(pi, ji)
    _eq(pm, jm)


@pytest.mark.parametrize("which", ["packable", "all"])
def test_fk_gather_by_rank_matches_jax(which):
    rng = np.random.default_rng(9)
    cap_l, cap_r, n_ranks = 512, 256, 300
    cols = _build_side(rng, cap_r, 220)
    if which == "packable":
        cols = cols[:3]
    lr, rr = _ranks(rng, cap_l, cap_r, 500, 220, n_ranks)
    l_live = np.arange(cap_l) < 500
    r_live = np.arange(cap_r) < 220
    datas = [c[0] for c in cols]
    valids = [c[1] for c in cols]
    bounds = [c[2] for c in cols]
    got = TK.fk_gather_by_rank(
        [_t(d) for d in datas], [_t(v) for v in valids], bounds, _t(rr),
        _t(r_live), _t(lr), _t(l_live), n_ranks,
    )
    want = JK.fk_gather_by_rank(
        [jnp.asarray(d) for d in datas], [jnp.asarray(v) for v in valids],
        bounds, jnp.asarray(rr), jnp.asarray(r_live), jnp.asarray(lr),
        jnp.asarray(l_live), n_ranks,
    )
    if which == "all":  # a float or unbounded column: no fused path
        assert got is None and want is None
        return
    pd, pv, pm = got
    jd, jv, jm = want
    _eq(pm, jm)
    for a, b, d in zip(pd, jd, datas):
        assert a.dtype == _t(d).dtype
        _eq(a, b)
    for a, b in zip(pv, jv):
        _eq(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_positions_match_jax(seed):
    rng = np.random.default_rng(seed)
    change = rng.random(300) < 0.1
    change[0] = True
    _eq(TK._seg_start_pos(_t(change)), JK._seg_start_pos(jnp.asarray(change)))
    _eq(TK._seg_end_pos(_t(change)), JK._seg_end_pos(jnp.asarray(change)))
