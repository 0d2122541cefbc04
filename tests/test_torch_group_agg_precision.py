"""The precision of the card's float SUM (query_engine_tpu_torch.ops.
group_agg), through the card's route on the CPU: `fixed_point` with
`accumulate_plain`, the kernel's plain version, bit for bit its rows.

A float item is quantized as q = rint(x * 2^k) with k = 62 - e for max|x|
< 2^e, and its sum is kept exactly in two int64 rows (the low and the high
32 bits of each q, summed apart). So a group's sum depends on its own rows
and max|x| alone, not on the plane's capacity, and is the exact sum of the
quantized values rounded once to float64. Inputs come from numpy with a
fixed seed.
"""

import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops import kernels as JK
from query_engine_tpu_torch.ops import group_agg as tga
from query_engine_tpu_torch.tpch import data, scalar
from query_engine_tpu_torch.tpch.oracle import _T

RTOL = 1e-9
ULPS = 2  # a sum within this many ulp of math.fsum of its group


def _card(items, gid, G):
    return tga.fixed_point(items, gid, G, tga.accumulate_plain)


def _bits(t):
    return t.view(torch.int64) if t.is_floating_point() else t


def _lineitem(rng, n):
    """l_extendedprice, l_discount, l_quantity and ps_supplycost drawn as
    tpch/data.py draws them."""
    ep = np.round(rng.uniform(900, 105000, n), 2)
    disc = np.round(rng.uniform(0.0, 0.1, n), 2)
    qty = rng.integers(1, 51, n).astype(np.float64)
    cost = np.round(rng.uniform(1.0, 1000.0, n), 2)
    return ep, disc, qty, cost


@pytest.mark.parametrize("seed", [0, 1])
def test_sums_do_not_depend_on_the_plane_capacity(seed):
    """The same live rows in a plane of 2^12 rows and in one of 2^24 (the
    rest pad rows, not ok) give bit-identical sums and counts."""
    rng = np.random.default_rng(seed)
    n_live, G = 3000, 37
    ep, disc, qty, cost = _lineitem(rng, n_live)
    cols = [ep * (1 - disc) - cost * qty,  # Q9's amount: both signs
            rng.normal(0.0, 1e6, n_live)]
    ok = [rng.random(n_live) < 0.9 for _ in cols]
    gid = rng.integers(0, G, n_live)
    got = []
    for cap in (1 << 12, 1 << 24):
        g = np.zeros(cap, np.int64)
        g[:n_live] = gid
        items = []
        for x, o in zip(cols, ok):
            v, m = np.zeros(cap), np.zeros(cap, bool)
            v[:n_live], m[:n_live] = x, o
            items.append((torch.from_numpy(v), torch.from_numpy(m)))
        got.append(_card(items, torch.from_numpy(g), G))
    for (s, c), (s2, c2) in zip(*got):
        assert torch.equal(c, c2)
        assert torch.equal(_bits(s), _bits(s2))


class _Plane:
    """A plane of 2^24 rows: TPC-H's columns as data.generate draws them,
    one grouping and ok plane, and the rows in group order (for fsum)."""

    def __init__(self, seed, gid, ok):
        rng = np.random.default_rng(seed)
        n = len(gid)
        self.ep, self.disc, self.qty, self.cost = _lineitem(rng, n)
        self.gid, self.ok = gid, ok
        self.G = int(gid.max()) + 1
        self.order = np.argsort(gid, kind="stable")
        self.cuts = np.cumsum(np.bincount(gid, minlength=self.G))[:-1]

    def held(self, x):
        """One float item at the card's route against the JAX package's
        CPU path (`segment_aggregate("sum")`, float64) at rtol 1e-9 and no
        atol, and against math.fsum per group within ULPS ulp."""
        gid, ok, G = self.gid, self.ok, self.G
        (s, c), = _card([(torch.from_numpy(x), torch.from_numpy(ok))],
                        torch.from_numpy(gid), G)
        jax_sum, _ = JK.segment_aggregate(
            "sum", jnp.asarray(x), jnp.asarray(ok), jnp.asarray(gid),
            len(x), G)
        s = s.numpy()
        np.testing.assert_allclose(s, np.asarray(jax_sum), rtol=RTOL,
                                   atol=0)
        exact = np.array([math.fsum(p) for p in np.split(
            np.where(ok, x, 0.0)[self.order], self.cuts)])
        assert np.all(np.abs(s - exact) <= ULPS * np.spacing(np.abs(exact)))
        np.testing.assert_array_equal(c.numpy(), np.bincount(gid[ok],
                                                             minlength=G))


N24 = 1 << 24


def test_q9_amounts_at_capacity_2_24():
    """Q9's amount, ep * (1 - d) - sc * qty, over 175 groups (nation x
    year) in a plane of 2^24 rows, the last 1000 pad rows."""
    rng = np.random.default_rng(9)
    p = _Plane(9, rng.integers(0, 175, N24), np.arange(N24) < N24 - 1000)
    p.held(p.ep * (1 - p.disc) - p.cost * p.qty)


@pytest.fixture(scope="module")
def f1_plane():
    """F1's four (l_returnflag, l_linestatus) groups, ~2 % of rows outside
    its date bound."""
    rng = np.random.default_rng(1)
    return _Plane(1, rng.choice(4, N24, p=[0.25, 0.01, 0.49, 0.25]),
                  rng.random(N24) < 0.98)


@pytest.mark.parametrize("moment", ["x", "x*x", "x*y", "y", "y*y"])
def test_f1_moments_at_capacity_2_24(f1_plane, moment):
    """F1's one-pass sums (x l_quantity, y l_extendedprice) in a plane of
    2^24 rows."""
    p = f1_plane
    p.held({"x": p.qty, "x*x": p.qty * p.qty, "x*y": p.qty * p.ep,
            "y": p.ep, "y*y": p.ep * p.ep}[moment])


def test_exact_integer_sums_at_max_abs():
    """Groups of 2^20 rows: every row +M (q = 2^62 - 2^9: the low words
    carry into sum_hi), every row -M, all-negative values below M, and +-M
    alternating. sum_hi * 2^32 + sum_lo equals the exact sum of q as a
    Python int, and the float sum is that int rounded once and scaled."""
    rng = np.random.default_rng(3)
    m = 1 << 20
    M = 1024 - 2.0 ** -43  # (2^62 - 2^9) * 2^-52: 53 bits, e = 10
    x = np.concatenate([np.full(m, M), np.full(m, -M),
                        -rng.uniform(0.0, M, m),
                        np.where(np.arange(m) % 2 == 0, M, -M)])
    gid = np.repeat(np.arange(4), m)
    perm = rng.permutation(4 * m)
    x, gid = x[perm], gid[perm]
    ok = np.ones(4 * m, bool)
    items = [(torch.from_numpy(x), torch.from_numpy(ok))]
    rows, inv = tga.accumulate_plain(items, torch.from_numpy(gid), 4)
    k = 62 - math.frexp(M)[1]
    assert k == 52 and float(inv[0]) == 2.0 ** -k
    q = np.rint(x * 2.0 ** k).astype(np.int64)
    assert int(np.abs(q).max()) == 2**62 - 2**9
    lo, hi = rows[0].tolist(), rows[1].tolist()
    assert min(lo) >= 0 and max(lo) >= 2**32  # the low words carried
    (s, c), = tga.fixed_point(items, torch.from_numpy(gid), 4,
                              tga.accumulate_plain)
    for g in range(4):
        exact = sum(int(v) for v in q[gid == g])
        assert hi[g] * 2**32 + lo[g] == exact
        assert float(s[g]) == float(exact) * 2.0 ** -k
        assert int(c[g]) == m
    assert exact == 0 and float(s[3]) == 0.0  # +-M cancel exactly
    assert float(s[0]) == -float(s[1]) == m * M


def test_flags_for_inf_and_nan():
    """+inf, -inf and NaN rows set flag bits 1, 2 and 4 of their group and
    give IEEE sums; they count, and finite rows' sums ignore them."""
    x = np.array([1.5, np.inf, 2.0, -np.inf, np.nan, np.inf, -np.inf, 3.0,
                  np.nan, 4.0, 5.0, 1e300])
    gid = np.array([0, 0, 1, 1, 2, 3, 3, 4, 4, 5, 5, 5])
    ok = np.ones(len(x), bool)
    ok[-1] = False  # an excluded row does not set max|x|
    items = [(torch.from_numpy(x), torch.from_numpy(ok))]
    rows, inv = tga.accumulate_plain(items, torch.from_numpy(gid), 6)
    assert rows.shape == (4, 6)
    assert rows[3].tolist() == [1, 2, 4, 3, 4, 0]
    assert rows[2].tolist() == [2, 2, 1, 2, 2, 2]
    assert float(inv[0]) == 2.0 ** -(62 - 3)  # max|x| = 5 < 2^3
    (s, c), = tga.fixed_point(items, torch.from_numpy(gid), 6,
                              tga.accumulate_plain)
    s = s.tolist()
    assert s[0] == math.inf and s[1] == -math.inf and math.isnan(s[2])
    assert math.isnan(s[3]) and math.isnan(s[4]) and s[5] == 9.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_bits_under_a_permutation_of_the_rows(seed):
    rng = np.random.default_rng(seed)
    n, G = 1 << 16, 300
    ep, disc, qty, cost = _lineitem(rng, n)
    x = ep * (1 - disc) - cost * qty
    x[rng.permutation(n)[:4]] = [np.inf, -np.inf, np.nan, np.inf]
    gid = rng.integers(-1, G, n)
    ok = rng.random(n) < 0.9
    perm = rng.permutation(n)
    got = [_card([(torch.from_numpy(x[p]), torch.from_numpy(ok[p]))],
                 torch.from_numpy(gid[p]), G)
           for p in (np.arange(n), perm)]
    (s, c), (s2, c2) = got[0][0], got[1][0]
    assert torch.equal(c, c2) and torch.equal(_bits(s), _bits(s2))


def test_f2_exact_oracle_rounds_ties_as_exact_arithmetic():
    """F2's oracle with exact sums (the card's) gives each quarter's
    ROUND(AVG(o_totalprice), 2) as exact rational arithmetic over the float
    inputs does, where numpy's float64 summation may put a tied mean on the
    other side."""
    tables = data.generate(1 << 11)
    rows = scalar.run("F2", tables, exact_sums=True)
    o, _, code, cnt, _ = scalar._f2_avgs({k: _T(v)
                                          for k, v in tables.items()})
    for g, row in enumerate(rows):
        mean = sum(map(Fraction, o.o_totalprice[code == g])) / int(cnt[g])
        want = math.floor(mean * 100 + Fraction(1, 2)) / 100
        assert row[2] == float(Fraction(want)), (g, row, float(mean))
