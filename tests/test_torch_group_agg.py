"""The port's grouped SUM/COUNT (query_engine_tpu_torch.ops.group_agg)
against the JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it.

Inputs come from numpy with a fixed seed. Integer results must match
exactly. Float sums: the JAX kernel sums dynamic-scale fixed point, the
port's CPU path sums float64; they agree to rtol 1e-9 with atol
max|x| * 1e-9 (fixed-point rounding of ~n * max|x| * 2^-40 against float64
round-off — the bound tests/test_pallas_kernels.py uses).
"""

import functools

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
    return [(torch.from_numpy(v), torch.from_numpy(ok)) for v, ok in items]


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
    """The kernel path's prep and finish (quantize, flag columns, rescale)
    composed with the plain int64 accumulator — the arithmetic the CUDA
    kernel runs, on the CPU."""
    gid, items, ref = _reference(n, G, ieee)
    got = tga.fixed_point_multi(_torch_items(items), torch.from_numpy(gid),
                                G, tga.accumulate_plain)
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
        tga.fixed_point_multi([(torch.from_numpy(vals), torch.from_numpy(ok))],
                              torch.from_numpy(gid), 5,
                              tga.accumulate_plain)[0],
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
    s, _ = tga.fixed_point_multi(
        [(torch.from_numpy(big), torch.from_numpy(ok))],
        torch.from_numpy(gid), 2, tga.accumulate_plain)[0]
    np.testing.assert_array_equal(s.numpy(), want)
    s, _ = tga.grouped_sum_count(torch.from_numpy(big), torch.from_numpy(ok),
                                 torch.from_numpy(gid), 2)
    np.testing.assert_array_equal(s.numpy(), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises instead of falling back."""
    gid = torch.zeros(8, dtype=torch.int32)
    vals = torch.zeros((1, 8), dtype=torch.int64)
    ok = torch.ones((1, 8), dtype=torch.bool)
    before = tga.launches
    with pytest.raises(ValueError, match="CUDA"):
        tga.accumulate_kernel(gid, vals, ok, 4)
    assert tga.launches == before
