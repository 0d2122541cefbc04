"""The count program's join functions against the JAX package's.

`join_count_total` (the join's size and its matched left and right rows
from one joint sort, with the sorted space it hands to the emit program)
and `join_ranks_counts` (join_ranks + join_counts from one joint sort, or
from a sorted space handed over) of `query_engine_tpu_torch.ops.kernels`
against `query_engine_tpu.ops.kernels`' on the same seeded numpy inputs,
run on the CPU: 1-3 key columns of int32, int64, float64 and huge-range
(10^15) keys, NULL keys, pad rows (live rows below the capacity) and empty
sides. Every output is an integer plane or scalar and must be exactly
equal (values: the port's index planes are int64). Both are also held
against the port's own join_ranks + join_counts.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu_torch.ops import kernels as TK

CAP_L, CAP_R = 256, 128


def _keys(rng, kind, cap, n_keys, null_frac):
    out = []
    for _ in range(n_keys):
        if kind == "i32":
            d = rng.integers(-6, 6, cap).astype(np.int32)
        elif kind == "i64":
            d = rng.integers(-6, 6, cap)
        elif kind == "f64":
            d = rng.integers(-12, 12, cap) / 2.0
        elif kind == "huge":
            d = 10**15 + rng.integers(0, 9, cap)
        else:
            raise ValueError(kind)
        v = rng.random(cap) >= null_frac
        out.append((d, v))
    return out


def _j(keys):
    return [(jnp.asarray(d), jnp.asarray(v)) for d, v in keys]


def _t(keys):
    return [(torch.from_numpy(np.ascontiguousarray(d)),
             torch.from_numpy(np.ascontiguousarray(v))) for d, v in keys]


def _eq(port, ref):
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    np.testing.assert_array_equal(p.astype(np.int64), r.astype(np.int64))


# (key kind, key columns, NULL share, live left rows, live right rows)
CASES = [
    ("i64", 1, 0.0, CAP_L, CAP_R),
    ("i64", 1, 0.1, 201, 97),
    ("i32", 1, 0.1, 201, 97),
    ("f64", 1, 0.1, 201, 97),
    ("huge", 1, 0.1, 201, 97),
    ("i64", 2, 0.1, 180, 120),
    ("i32", 2, 0.05, 256, 50),
    ("f64", 2, 0.0, 77, 128),
    ("huge", 2, 0.1, 201, 97),
    ("i64", 3, 0.05, 201, 97),
    ("huge", 3, 0.0, 150, 128),
    ("i64", 1, 0.1, 0, 97),   # empty left side
    ("i64", 2, 0.1, 201, 0),  # empty right side
    ("f64", 1, 0.1, 0, 0),    # both empty
    ("i64", 1, 1.0, 201, 97),  # every key NULL
]


def _case(kind, n_keys, null_frac, n_l, n_r):
    rng = np.random.default_rng(
        zlib.crc32(repr((kind, n_keys, null_frac, n_l, n_r)).encode()))
    return (_keys(rng, kind, CAP_L, n_keys, null_frac),
            _keys(rng, kind, CAP_R, n_keys, null_frac))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_join_count_total_matches_jax(case):
    lk, rk = _case(*case)
    n_l, n_r = case[3], case[4]
    got = TK.join_count_total(_t(lk), _t(rk), n_l, n_r, return_space=True)
    want = JK.join_count_total(_j(lk), _j(rk), n_l, n_r, return_space=True)
    for g, w in zip(got[:3], want[:3]):
        _eq(g, w)
    for g, w in zip(got[3], want[3]):  # the sorted space, plane by plane
        _eq(g, w)
    plain = TK.join_count_total(_t(lk), _t(rk), n_l, n_r)
    for g, w in zip(plain, got[:3]):
        _eq(g, w.numpy())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("handed", [False, True],
                         ids=["own_sort", "count_space"])
def test_join_ranks_counts_matches_jax(case, handed):
    lk, rk = _case(*case)
    n_l, n_r = case[3], case[4]
    space_t = space_j = None
    if handed:
        space_t = TK.join_count_total(_t(lk), _t(rk), n_l, n_r,
                                      return_space=True)[3]
        space_j = JK.join_count_total(_j(lk), _j(rk), n_l, n_r,
                                      return_space=True)[3]
    got = TK.join_ranks_counts(_t(lk), _t(rk), n_l, n_r, space=space_t)
    want = JK.join_ranks_counts(_j(lk), _j(rk), n_l, n_r, space=space_j)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_fused_forms_equal_the_port_two_step(case):
    """join_ranks_counts == join_ranks then join_counts, and
    join_count_total's size and matched rows == join_counts' totals."""
    lk, rk = _case(*case)
    n_l, n_r = case[3], case[4]
    lr, rr = TK.join_ranks(_t(lk), _t(rk), n_l, n_r)
    two = TK.join_counts(lr, rr, n_l, n_r)
    fused = TK.join_ranks_counts(_t(lk), _t(rk), n_l, n_r)
    for g, w in zip(fused, (lr, rr) + tuple(two)):
        _eq(g, w.numpy())
    total, ml, mr = TK.join_count_total(_t(lk), _t(rk), n_l, n_r)
    assert int(total) == int(two[0])
    assert int(ml) == int(two[5].sum())
    assert int(mr) == int(two[6].sum())


def test_emit_over_the_fused_counts_lists_every_pair():
    """join_emit_inner over join_ranks_counts' planes gives exactly the
    equal-key pairs, left-major (numpy's pairs as the oracle)."""
    rng = np.random.default_rng(3)
    lk = _keys(rng, "i64", CAP_L, 2, 0.1)
    rk = _keys(rng, "i64", CAP_R, 2, 0.1)
    n_l, n_r = 230, 111
    out = TK.join_ranks_counts(_t(lk), _t(rk), n_l, n_r)
    lr, _, total, counts, _, rank_start, right_by_rank = out[:7]
    li, ri, valid = TK.join_emit_inner(counts, rank_start, right_by_rank,
                                       lr, total, 1024)
    got = sorted(zip(li[valid].tolist(), ri[valid].tolist()))
    want = sorted(
        (i, j) for i in range(n_l) for j in range(n_r)
        if all(lv[i] and rv[j] and ld[i] == rd[j]
               for (ld, lv), (rd, rv) in zip(lk, rk)))
    assert got == want
    assert li[valid].tolist() == sorted(li[valid].tolist())  # left-major
