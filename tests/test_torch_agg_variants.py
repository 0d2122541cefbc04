"""The port's one-hot aggregate probes against the JAX probes.

`query_engine_tpu_torch.probes.probe_agg_variants.run_variant` (v1, v2, v4,
v5) and `probe_int8_mxu.grouped_sum_count_s8` against the functions of the
same names in `benchmarks/`, loaded by path, whose Pallas kernels run in
interpret mode on the CPU. On the CPU the port runs the plain chunk totals
(`index_add_` over byte or nibble planes) and the shared recombination. The
same numpy inputs go to both: values over the whole int64 range with its
edges, ~3 % of rows not ok, gid -1 and out of range, a band of empty groups.
Sums (mod 2^64) and counts must be identical, and equal a numpy reference.
The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 6).
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu_torch.ops import agg_variants as AV
from query_engine_tpu_torch.probes import probe_agg_variants as PV
from query_engine_tpu_torch.probes.probe_int8_mxu import grouped_sum_count_s8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [1000, 10007, 3 * 8192 + 5]


def _load_jax_probe(name):
    path = os.path.join(ROOT, "benchmarks", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    return (_load_jax_probe("probe_agg_variants"),
            _load_jax_probe("probe_int8_mxu"))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    values = rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64,
                          endpoint=True)
    edges = [-(2**63), 2**63 - 1, -(2**63) + 1, 2**63 - 2, -1, 0, 1]
    values[rng.choice(n, len(edges), replace=False)] = edges
    ok = rng.random(n) > 0.03
    allowed = np.setdiff1d(np.arange(1024), np.arange(500, 564))  # empty
    gid = rng.choice(allowed, n).astype(np.int32)
    gid[rng.random(n) < 0.02] = -1
    odd = [1024, 1100, 1407, 1408, 5000, 2**31 - 1, -5, -(2**31)]
    gid[rng.choice(n, len(odd), replace=False)] = odd
    return values, ok, gid


def _port(fn, values, ok, gid, *args):
    s, c = fn(torch.from_numpy(values), torch.from_numpy(ok),
              torch.from_numpy(gid), *args)
    assert s.dtype == torch.int64 and c.dtype == torch.int64
    return s.numpy(), c.numpy()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", ["v1", "v2", "v4", "v5"])
def test_run_variant_matches_jax(jax_probes, variant, n):
    jv, _ = jax_probes
    values, ok, gid = _inputs(n, n + ord(variant[1]))
    s, c = _port(PV.run_variant, values, ok, gid, variant)
    js, jc = jv.run_variant(jnp.asarray(values), jnp.asarray(ok),
                            jnp.asarray(gid), variant)
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(c, np.asarray(jc).astype(np.int64))
    rs, rc = PV.reference(values, ok, gid)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(c, rc)
    assert (c[500:564] == 0).all() and (s[500:564] == 0).all()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("num_groups", [1024, 1000])
def test_s8_matches_jax(jax_probes, num_groups, n):
    _, js8 = jax_probes
    values, ok, gid = _inputs(n, n + num_groups)
    s, c = _port(grouped_sum_count_s8, values, ok, gid, num_groups)
    js, jc = js8.grouped_sum_count_s8(jnp.asarray(values), jnp.asarray(ok),
                                      jnp.asarray(gid), num_groups)
    assert s.shape == (num_groups,)
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(c, np.asarray(jc))
    rs, rc = PV.reference(values, ok, gid, num_groups)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(c, rc)


@pytest.mark.parametrize("variant", AV.VARIANTS)
def test_no_rows_gives_zeros(variant):
    e = torch.zeros(0, dtype=torch.int64)
    s, c = AV.grouped_sum_count(variant, e, e.bool(), e.int())
    assert s.shape == c.shape == (AV.NUM_GROUPS,)
    assert not s.any() and not c.any()


def test_recombine_wraps_mod_2_64():
    """Chunk totals far past one row's range: the int64 recombination must
    equal Python's sum of tot[k] * 2^(w k) mod 2^64."""
    rng = np.random.default_rng(0)
    for variant in ("v2", "s8"):
        w = AV.CHUNK_BITS[variant]
        k = 64 // w
        tot = rng.integers(0, 2**40, (5, AV.LANES[variant]), dtype=np.int64)
        tot[0, :k] = (1 << w) - 1  # all ones: -1 after recombination
        s, c = AV.recombine(variant, torch.from_numpy(tot))
        want = [(sum(int(t) << (w * i) for i, t in enumerate(row[:k]))
                 + 2**63) % 2**64 - 2**63 for row in tot]
        assert s.tolist() == want and s[0] == -1
        assert c.tolist() == tot[:, k].tolist()


def _kernel_constants(source):
    """(rows a k-step, rows between flushes) of a one-hot kernel, read from
    its CUDA source: `kRows = N;` and `kFlushRows = N;` (or `int64_t(1) <<
    K;`)."""
    text = open(os.path.join(ROOT, "query_engine_tpu_torch", "csrc",
                             source)).read()
    k_rows = int(re.search(r"\bkRows = (\d+);", text).group(1))
    flush = re.search(r"\bkFlushRows = ([^;]+);", text).group(1).strip()
    shift = re.fullmatch(r"int64_t\(1\) << (\d+)", flush)
    return k_rows, (1 << int(shift.group(1))) if shift else int(flush)


def _plain_totals(variant, rows, piece=1 << 19):
    """chunk_totals_plain of `rows` worst-case rows (value -1: every chunk
    at its maximum; all in group 0), in pieces to bound memory."""
    tot = torch.zeros((1, AV.LANES[variant]), dtype=torch.int64)
    for start in range(0, rows, piece):
        m = min(piece, rows - start)
        ones = torch.full((m,), -1, dtype=torch.int32)
        tot += AV.chunk_totals_plain(variant, ones, ones,
                                     torch.zeros(m, dtype=torch.int32))[:1]
    return tot


@pytest.mark.parametrize("variant,source,chunk_max,acc_dtype,limit", [
    ("s8", "agg_onehot_s8.cu", 15, torch.int32, 2**31),  # nibbles in s32
    ("v1", "agg_onehot_bytes.cu", 255, torch.float32, 2**24),  # bytes in f32
    ("v4", "agg_onehot_factorized.cu", 255, torch.float32, 2**24),
])
def test_flush_interval_keeps_accumulators_exact(variant, source, chunk_max,
                                                 acc_dtype, limit):
    """A kernel's accumulator (s32, or f32 exact below 2^24) holds at most
    kFlushRows rows of chunks before it is added into the int64 total.
    At worst-case values, one flush window's totals fit the accumulator
    exactly, and windows split at the flush boundaries add up to the
    whole."""
    k_rows, flush = _kernel_constants(source)
    assert flush % k_rows == 0  # a flush falls at the end of a k-step
    assert chunk_max * flush < limit and flush < limit
    n = flush + 2 * k_rows + 3  # one full window and a ragged one
    windows = [_plain_totals(variant, flush),
               _plain_totals(variant, n - flush)]
    for w in windows:
        assert int(w.max()) <= chunk_max * flush
        assert torch.equal(w.to(acc_dtype).to(torch.int64), w)
    whole = _plain_totals(variant, n, piece=(1 << 19) - 7)
    assert torch.equal(windows[0] + windows[1], whole)
    chunks = 64 // AV.CHUNK_BITS[variant]
    assert (whole[0, :chunks] == chunk_max * n).all()
    assert whole[0, chunks] == n
    s, c = AV.recombine(variant, whole)
    assert s.tolist() == [-n] and c.tolist() == [n]  # n rows of -1, mod 2^64


def _factorized_totals(vlo, vhi, gid_m):
    """The v4/v5 kernels' product in plain torch, in float64: A, the one-hot
    of glo = gid & 127 [128 x n], times B [n x 72], where an included row's
    chunk lane k sits at column 8 k + ghi (ghi = gid >> 7) and an excluded
    row is all zero. Column 8 k + ghi of D's row glo is lane k of group
    ghi * 128 + glo, as the kernel's flush maps it."""
    n = gid_m.shape[0]
    g = gid_m.to(torch.int64)
    included = (g >= 0) & (g < AV.NUM_GROUPS)
    glo, ghi = g & 127, torch.where(included, g >> 7, 0)
    a = torch.zeros((128, n), dtype=torch.float64)
    a[glo, torch.arange(n)] = 1.0
    chunks = AV.chunk_planes("v4", vlo, vhi).to(torch.float64)
    b = torch.zeros((n, 8 * AV.LANES["v4"]), dtype=torch.float64)
    b.scatter_(1, 8 * torch.arange(AV.LANES["v4"]) + ghi[:, None],
               chunks * included[:, None])
    d = a @ b  # [glo, 8 k + ghi]: integers below 2^53, exact
    return d.reshape(128, AV.LANES["v4"], 8).permute(2, 0, 1).reshape(
        AV.NUM_GROUPS, AV.LANES["v4"]).to(torch.int64)


@pytest.mark.parametrize("n", SIZES[:2])
def test_factorized_product_equals_plain(n):
    """The factorized product and its mapping back to [1024, 9] give the
    plain chunk totals bit for bit, on rows with gid -1, 1024 and beyond,
    and values at +-2^63."""
    values, ok, gid = _inputs(n, 7 * n)
    assert (gid == -1).any() and (gid == 1024).any()
    assert values.min() == -(2**63) and values.max() == 2**63 - 1
    vlo, vhi, gid_m = AV.prepare(*(torch.from_numpy(x)
                                   for x in (values, ok, gid)))
    want = AV.chunk_totals_plain("v4", vlo, vhi, gid_m)
    assert torch.equal(_factorized_totals(vlo, vhi, gid_m), want)


def test_checks_variant_groups_and_device():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        AV.chunk_totals("v4", x, x, x, 1000)  # v1-v5: exactly 1024 groups
    with pytest.raises(ValueError):
        AV.chunk_totals("s8", x, x, x, 1025)
    with pytest.raises(ValueError):
        AV.chunk_totals("v3", x, x, x, 1024)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        AV.chunk_totals_kernel("v2", x, x, x)
    with pytest.raises(ValueError):
        PV.run_variant(x.long(), x.bool(), x, "s8")


def test_probe_main_on_cpu(capsys):
    assert PV.main(["3000", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"device": "cpu"' in last and '"correct": false' not in last


def test_probes_import_no_jax():
    code = (
        "import sys, torch\n"
        "from query_engine_tpu_torch.probes import probe_agg_variants as P\n"
        "from query_engine_tpu_torch.probes import probe_int8_mxu as S\n"
        "v, ok, g = P.probe_data(5000, 'cpu')\n"
        "rs, rc = P.reference(v.numpy(), ok.numpy(), g.numpy())\n"
        "for var in ('v1', 'v2', 'v4', 'v5'):\n"
        "    s, c = P.run_variant(v, ok, g, var)\n"
        "    assert (s.numpy() == rs).all() and (c.numpy() == rc).all(), var\n"
        "s, c = S.grouped_sum_count_s8(v, ok, g, 1024)\n"
        "assert (s.numpy() == rs).all() and (c.numpy() == rc).all()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'query_engine_tpu' or "
        "m.startswith('query_engine_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
