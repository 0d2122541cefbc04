"""The port's grouped SUM/COUNT (query_engine_tpu_torch.ops.group_agg)
against the JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it, and against the card's route as it was
before the kernel read its items where they lie.

Inputs come from numpy with a fixed seed. Integer results must match
exactly. Float sums: the JAX kernel sums dynamic-scale fixed point, the
port's CPU path sums float64; they agree to rtol 1e-9 with atol
max|x| * 1e-9 (the JAX kernel's fixed-point rounding of ~n * max|x| * 2^-40
against float64 round-off — the bound tests/test_pallas_kernels.py uses).
The card's route (`fixed_point` with `accumulate_plain`) must give the same
bits as the stacked-plane route it replaced (`_stacked_route` below), with
a float item's q stacked as its two halves.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops.pallas import group_agg as jga
from query_engine_tpu_torch.ops import group_agg as tga

RTOL = 1e-9


def _assert_sums(port, ref, values):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    if np.issubdtype(ref.dtype, np.integer):
        assert port.dtype == np.int64
        np.testing.assert_array_equal(port, ref)
        return
    x = np.asarray(values, dtype=np.float64)
    fin = x[np.isfinite(x)]
    atol = (np.abs(fin).max() if fin.size else 1.0) * 1e-9
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=atol)
    # IEEE classes agree exactly: same infinities, same NaNs
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(port) * np.sign(port),
                                  np.isinf(ref) * np.sign(ref))


def _case(n, G, seed, ieee=False):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, n).astype(np.int32)
    gid[rng.random(n) < 0.05] = -1  # excluded rows
    if G > 4:
        gid[gid == 3] = 2  # group 3 stays empty
    ints = rng.integers(-(1 << 40), 1 << 40, n)
    floats = rng.normal(0.0, 1e7, n)
    if ieee:
        idx = rng.permutation(n)
        floats[idx[:3]] = np.inf
        floats[idx[3:5]] = -np.inf
        floats[idx[5:6]] = np.nan
    ok_i = rng.random(n) > 0.15
    ok_f = rng.random(n) > 0.25
    return gid, [(ints, ok_i), (floats, ok_f)]


@functools.lru_cache(maxsize=None)
def _reference(n, G, ieee):
    """(gid, items, JAX results) of one case; the Pallas interpret run is
    the slow part, so both tests of a case share it."""
    gid, items = _case(n, G, n + G, ieee)
    ref = jga.grouped_sums_counts_multi(
        [(jnp.asarray(v), jnp.asarray(ok)) for v, ok in items],
        jnp.asarray(gid), G,
    )
    return gid, items, [(np.asarray(s), np.asarray(c)) for s, c in ref]


def _torch_items(items):
    return [(None if v is None else torch.from_numpy(v), torch.from_numpy(ok))
            for v, ok in items]


CASES = [(100, 7, False), (5000, 37, False), (2048, 1024, False),
         (3000, 41, True)]


@pytest.mark.parametrize("n,G,ieee", CASES)
def test_multi_plain_matches_jax(n, G, ieee):
    gid, items, ref = _reference(n, G, ieee)
    got = tga.grouped_sums_counts_multi(_torch_items(items),
                                        torch.from_numpy(gid), G)
    assert len(got) == len(ref) == 2
    for (s, c), (rs, rc), (v, _) in zip(got, ref, items):
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        _assert_sums(s, rs, v)
    if G > 4:
        assert int(got[0][1][3]) == 0 and int(got[0][0][3]) == 0


@pytest.mark.parametrize("n,G,ieee", CASES)
def test_fixed_point_with_plain_accumulator_matches_jax(n, G, ieee):
    """The card's route (item descriptors, in-kernel quantization, flag
    rows, rescale) with the kernel's plain version — the arithmetic the
    CUDA kernel runs, on the CPU."""
    gid, items, ref = _reference(n, G, ieee)
    got = tga.fixed_point(_torch_items(items), torch.from_numpy(gid), G,
                          tga.accumulate_plain)
    for (s, c), (rs, rc), (v, _) in zip(got, ref, items):
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        _assert_sums(s, rs, v)


@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_grouped_sum_count_matches_jax(dtype):
    gid, items = _case(5000, 37, 11)
    v, ok = items[0] if dtype == "int64" else items[1]
    rs, rc = jga.grouped_sum_count(jnp.asarray(v), jnp.asarray(ok),
                                   jnp.asarray(np.maximum(gid, 0)), 37)
    s, c = tga.grouped_sum_count(torch.from_numpy(v), torch.from_numpy(ok),
                                 torch.from_numpy(np.maximum(gid, 0)), 37)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    _assert_sums(s, rs, v)


def test_ieee_semantics_per_group():
    vals = np.array([1.0, np.inf, 2.0, -np.inf, np.inf, -np.inf, np.nan, 5.0])
    gid = np.array([0, 0, 1, 1, 2, 2, 3, 4], np.int32)
    ok = np.ones(8, bool)
    for s, c in (
        tga.grouped_sum_count(torch.from_numpy(vals), torch.from_numpy(ok),
                              torch.from_numpy(gid), 5),
        tga.fixed_point([(torch.from_numpy(vals), torch.from_numpy(ok))],
                        torch.from_numpy(gid), 5, tga.accumulate_plain)[0],
    ):
        s = s.numpy()
        assert s[0] == np.inf and s[1] == -np.inf
        assert np.isnan(s[2]) and np.isnan(s[3]) and s[4] == 5.0
        assert c.tolist() == [2, 2, 2, 1, 1]


def test_int64_sums_wrap_like_twos_complement():
    big = np.array([(1 << 62) + 5, (1 << 62) + 7, -(1 << 63), -1], np.int64)
    gid = np.array([0, 0, 1, 1], np.int32)
    ok = np.ones(4, bool)
    want = big.astype(np.uint64)
    want = (want[[0, 2]] + want[[1, 3]]).view(np.int64)  # wraps mod 2^64
    s, _ = tga.fixed_point(
        [(torch.from_numpy(big), torch.from_numpy(ok))],
        torch.from_numpy(gid), 2, tga.accumulate_plain)[0]
    np.testing.assert_array_equal(s.numpy(), want)
    s, _ = tga.grouped_sum_count(torch.from_numpy(big), torch.from_numpy(ok),
                                 torch.from_numpy(gid), 2)
    np.testing.assert_array_equal(s.numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises instead of falling back."""
    gid = torch.zeros(8, dtype=torch.int32)
    items = [(torch.zeros(8, dtype=torch.int64), torch.ones(8, dtype=bool)),
             (None, torch.ones(8, dtype=bool))]
    before = tga.launches
    with pytest.raises(ValueError, match="CUDA"):
        tga.accumulate_kernel(items, gid, 4)
    assert tga.launches == before


# ---------------------------------------------------------------------------
# the card's route against the stacked-plane route it replaced
# ---------------------------------------------------------------------------


def _stacked_accumulate(gid, vals, ok, num_groups):
    """The replaced kernel's contract: gid [n], vals [C, n] int64, ok [C, n]
    -> sums [C, G], counts [C, G] by int64 index_add_."""
    g = gid.to(torch.int64)
    ok = ok & ((g >= 0) & (g < num_groups))
    g = torch.where(ok, g, torch.zeros_like(g))
    n_cols = vals.shape[0]
    flat = (torch.arange(n_cols)[:, None] * num_groups + g).reshape(-1)
    sums = torch.zeros(n_cols * num_groups, dtype=torch.int64)
    counts = torch.zeros(n_cols * num_groups, dtype=torch.int64)
    sums.index_add_(0, flat, torch.where(ok, vals, 0).reshape(-1))
    counts.index_add_(0, flat, ok.to(torch.int64).reshape(-1))
    return sums.view(n_cols, num_groups), counts.view(n_cols, num_groups)


def _flags(n_pos, n_neg, n_nan):
    return ((n_pos > 0).to(torch.int64) | (n_neg > 0).to(torch.int64) << 1
            | (n_nan > 0).to(torch.int64) << 2)


def _stacked_route(items, gid, num_groups):
    """The card's route before this design: every item stacked into int64
    planes (a float as the low and high halves of q and three flag
    columns, COUNT(*) as a plane of ones), one accumulate, then the same
    rescale."""
    gid32 = gid.to(torch.int32)
    vals, oks, layout = [], [], []
    for v, ok in items:
        if v is None:
            v = torch.ones(gid.shape[0], dtype=torch.int64)
        layout.append((len(vals), None))
        if v.is_floating_point():
            q, inv = tga.quantize(v, ok)
            x = v.to(torch.float64)
            layout[-1] = (len(vals), inv)
            lo, hi = q & tga.LOW, q >> tga.HALF
            vals += [lo, hi, lo, lo, lo]
            oks += [ok, ok, ok & torch.isposinf(x), ok & torch.isneginf(x),
                    ok & torch.isnan(x)]
        else:
            vals.append(v.to(torch.int64))
            oks.append(ok)
    sums, counts = _stacked_accumulate(gid32, torch.stack(vals),
                                       torch.stack(oks), num_groups)
    return [(sums[c], counts[c]) if inv is None else
            (tga.finish_float(sums[c], sums[c + 1],
                              _flags(*counts[c + 2:c + 5]), inv), counts[c])
            for c, inv in layout]


def _route_case(case, seed=0):
    """(gid, items, G) for the shapes the engine gives the kernel."""
    rng = np.random.default_rng(seed + len(case))
    n, G = 4096, 128
    gid = rng.integers(0, G, n)
    if case == "few groups":  # Q1: 4 of 128 slots
        gid = rng.integers(0, 4, n)
    elif case == "sorted runs":  # Q3: ids follow row order in short runs
        gid = np.repeat(np.arange(n), rng.integers(1, 8, n))[:n]
        G = int(gid.max()) + 1
    elif case == "2^14 slots, few live":  # Q9: ~175 live of the slots
        G = 1 << 14
        gid = rng.integers(0, 175, n)
    elif case == "out of range":
        gid[rng.random(n) < 0.1] = -1
        gid[rng.random(n) < 0.05] = G + rng.integers(0, 100)
        gid[:2] = [-(2**31), 2**31 - 1]
    x = rng.normal(0.0, 1e5, n)
    x[rng.permutation(n)[:9]] = [np.inf, np.inf, -np.inf, -np.inf, np.nan,
                                 np.inf, -np.inf, np.nan, 1e300]
    items = [
        (None, rng.random(n) < 0.9),  # COUNT(*)
        (rng.integers(-(2**62), 2**62, n), rng.random(n) < 0.8),
        (rng.integers(-(2**31), 2**31, n).astype(np.int32),
         rng.random(n) < 0.7),
        (x, rng.random(n) < 0.85),
        (rng.normal(0, 3, n).astype(np.float32), rng.random(n) < 0.6),
        (rng.random(n) < 0.5, rng.random(n) < 0.9),  # bool values
    ]
    return torch.from_numpy(gid), _torch_items(items), G


ROUTE_CASES = ["uniform", "few groups", "sorted runs", "2^14 slots, few live",
               "out of range"]


def _bits(t):
    return t.view(torch.int64) if t.is_floating_point() else t


@pytest.mark.parametrize("gid_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ROUTE_CASES)
def test_card_route_same_bits_as_stacked_route(case, gid_dtype):
    """Count-only, int64, int32, bool, float64 (with +-inf, NaN and a huge
    value) and float32 items through the descriptor route give the bits of
    the stacked-plane route, sums and counts."""
    gid, items, G = _route_case(case)
    gid = gid.to(gid_dtype)
    got = tga.fixed_point(items, gid, G, tga.accumulate_plain)
    want = _stacked_route(items, gid, G)
    for (s, c), (ws, wc) in zip(got, want):
        assert torch.equal(c, wc)
        assert s.dtype == ws.dtype
        assert torch.equal(_bits(s), _bits(ws))


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_plain_contract_rows(case):
    """The [R, G] rows of `accumulate_plain`: one row for a COUNT item, sum
    and count for an integer item, sum_lo, sum_hi, count and flag bits for
    a float item, and one inverse scale per float item. A float item's
    sum_hi * 2^32 + sum_lo is the exact sum of its q = rint(x * 2^k), k =
    62 - e for max|x| < 2^e, checked with Python ints."""
    gid, items, G = _route_case(case, seed=1)
    rows, inv = tga.accumulate_plain(items, gid, G)
    assert rows.shape == (1 + 2 + 2 + 4 + 4 + 2, G)
    assert rows.dtype == torch.int64 and inv.shape == (2,)
    g = gid.numpy()
    in_range = (g >= 0) & (g < G)
    count_star = np.bincount(g[in_range & items[0][1].numpy()], minlength=G)
    np.testing.assert_array_equal(rows[0].numpy(), count_star)
    x, ok = items[3][0].numpy(), items[3][1].numpy() & in_range
    for bit, cls in enumerate((np.isposinf(x), np.isneginf(x), np.isnan(x))):
        has = np.bincount(g[ok & cls], minlength=G) > 0
        np.testing.assert_array_equal((rows[8].numpy() >> bit) & 1, has)
    assert int(rows[8].max()) <= 7
    np.testing.assert_array_equal(rows[7].numpy(),
                                  np.bincount(g[ok], minlength=G))
    fin = ok & np.isfinite(x)
    e = math.frexp(float(np.abs(x[items[3][1].numpy()
                                  & np.isfinite(x)]).max()))[1]
    k = 62 - e
    assert float(inv[0]) == 2.0 ** -k
    exact = [0] * G
    for gi, xi in zip(g[fin], x[fin]):
        exact[gi] += round(float(xi) * 2.0 ** k)
    assert all(0 <= lo < 2**63 for lo in rows[5].tolist())
    got = [hi * 2**32 + lo for lo, hi in zip(rows[5].tolist(),
                                             rows[6].tolist())]
    assert got == exact
