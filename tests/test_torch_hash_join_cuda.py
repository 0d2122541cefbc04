"""The hash join's kernels (`csrc/hash_join.cu`) on the card, held against
their plain versions on the same CUDA tensors. Each test skips without a
CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_hash_join_cuda.py -m cuda

* the build kernel's table is a pair of views of one packed tensor
  (`packed_of`) and passes `check_table` (the same entries as the plain
  build, each on its own probe sequence with no empty slot before it) for
  int32 and int64 keys at load 0.5 and 0.9, and the chains of 100 keys
  4096 apart at 128 slots;
* the probe kernel's (ri, matched) equal the plain probe's, on the
  kernel's packed table, on the plain build's separate planes (packed
  once) and on a caller's packing of them, and a dict of the live build
  keys; on views of a packed table it packs nothing;
* each entry point launches its kernel once a call;
* a table too small for its live rows raises ValueError (after the probe
  for `hash_join_unique`); a full table's probe for an absent key misses;
* the probe, and the build and probe together, replay in a CUDA graph;
* the build's fill gives `empty_table`, its plain version, where no row
  is live.
"""

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.ops import hash_join as TH

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(seed, dtype, T, load):
    rng = np.random.default_rng(seed)
    n_live = int(load * T)
    cap = n_live + 37
    lo, hi = (-(2**31), 2**31) if dtype == torch.int32 else (-(2**47), 2**47)
    keys = np.unique(rng.integers(lo, hi, 2 * cap))
    keys = keys[(keys != 0) & (keys != -1)]
    rng.shuffle(keys)
    keys = keys[:cap]
    keys[:2] = 0, -1
    ok = np.zeros(cap, bool)
    ok[rng.permutation(cap)[:n_live]] = True
    probe = np.concatenate([rng.choice(keys, 3 * cap),
                            rng.integers(lo, hi, cap)])
    pok = rng.random(len(probe)) >= 0.02
    np_dtype = np.int32 if dtype == torch.int32 else np.int64
    return keys.astype(np_dtype), ok, probe.astype(np_dtype), pok


def _oracle(keys, ok, probe, pok):
    lookup = {int(k): i for i, k in enumerate(keys) if ok[i]}
    hit = np.array([bool(o) and int(k) in lookup
                    for k, o in zip(probe, pok)])
    ri = np.array([lookup[int(k)] if h else 0 for k, h in zip(probe, hit)],
                  np.int64)
    return ri, hit


CASES = [(dtype, T, load) for dtype in (torch.int32, torch.int64)
         for T, load in ((1 << 12, 0.5), (1 << 16, 0.5), (1 << 16, 0.9))]


@pytest.mark.parametrize("dtype,T,load", CASES)
def test_kernels_match_plain_and_oracle(dev, dtype, T, load):
    keys, ok, probe, pok = _inputs(T + int(load * 10), dtype, T, load)
    k, o = torch.from_numpy(keys).to(dev), torch.from_numpy(ok).to(dev)
    p, po = torch.from_numpy(probe).to(dev), torch.from_numpy(pok).to(dev)
    before = dict(TH.launches)
    tk, tr = TH.hash_build(k, o, T)
    assert TH.launches["hash_build"] == before["hash_build"] + 1
    assert tk.is_cuda and tk.dtype == dtype and tr.dtype == torch.int32
    packed = TH.packed_of(tk, tr)
    assert packed is not None and packed.shape == (T, 2)
    assert packed.dtype == dtype and packed.data_ptr() % 16 == 0
    TH.check_table(tk, tr, k, o)
    pk, pr = TH.hash_build_plain(k, o, T)
    assert TH.packed_of(pk, pr) is None  # separate planes
    TH.check_table(pk, pr, k, o)
    want = TH.hash_probe_unique_plain(pk, pr, p, po)
    for table in ((tk, tr), (pk, pr),
                  TH.table_views(TH.pack_table(pk, pr))):
        ri, m = TH.hash_probe_unique(*table, p, po)
        assert ri.dtype == torch.int64 and m.dtype == torch.bool
        assert torch.equal(ri, want[0]) and torch.equal(m, want[1])
    assert TH.launches["hash_probe"] == before["hash_probe"] + 3
    ri, m = TH.hash_join_unique(p, po, k, o, T)
    assert torch.equal(ri, want[0]) and torch.equal(m, want[1])
    want_ri, want_m = _oracle(keys, ok, probe, pok)
    assert np.array_equal(ri.cpu().numpy(), want_ri)
    assert np.array_equal(m.cpu().numpy(), want_m)


def test_long_chains(dev):
    keys = torch.arange(100, dtype=torch.int64, device=dev) * 4096
    ok = torch.ones(100, dtype=torch.bool, device=dev)
    tk, tr = TH.hash_build(keys, ok, 128)
    TH.check_table(tk, tr, keys, ok)
    ri, m = TH.hash_probe_unique(tk, tr, keys, ok)
    assert bool(m.all()) and torch.equal(ri.cpu(), torch.arange(100))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_too_small_table_raises(dev, dtype):
    keys = (torch.arange(200, dtype=dtype) * 3 - 100).to(dev)
    ok = torch.ones(200, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="too small"):
        TH.hash_build(keys, ok, 128)
    with pytest.raises(ValueError, match="too small"):
        TH.hash_join_unique(keys, ok, keys, ok, 128)
    ok[128:] = False  # 128 live rows fill the table
    tk, tr = TH.hash_build(keys, ok, 128)
    TH.check_table(tk, tr, keys, ok)
    absent = torch.tensor([1, 4, 1000], dtype=dtype, device=dev)
    ri, m = TH.hash_probe_unique(tk, tr, absent,
                                 torch.ones(3, dtype=torch.bool, device=dev))
    assert not bool(m.any()) and not bool(ri.any())


def test_empty_and_no_live_rows(dev):
    e = torch.zeros(0, dtype=torch.int64, device=dev)
    eok = torch.zeros(0, dtype=torch.bool, device=dev)
    tk, tr = TH.hash_build(e, eok, 128)
    assert bool((tr == TH.EMPTY).all())
    keys = torch.zeros(5, dtype=torch.int64, device=dev)
    dead = torch.zeros(5, dtype=torch.bool, device=dev)
    tk, tr = TH.hash_build(keys, dead, 128)
    ri, m = TH.hash_probe_unique(tk, tr, keys, ~dead)
    assert not bool(m.any())  # key 0 never matches an empty slot


def test_probe_replays_in_a_graph(dev):
    keys, ok, probe, pok = _inputs(3, torch.int64, 1 << 14, 0.5)
    k, o = torch.from_numpy(keys).to(dev), torch.from_numpy(ok).to(dev)
    p, po = torch.from_numpy(probe).to(dev), torch.from_numpy(pok).to(dev)
    tk, tr = TH.hash_build(k, o, 1 << 14)
    want = TH.hash_probe_unique(tk, tr, p, po)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = TH.hash_probe_unique(tk, tr, p, po)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_long_chains_packed(dev, dtype):
    keys = (torch.arange(100, dtype=dtype) * 4096).to(dev)
    ok = torch.ones(100, dtype=torch.bool, device=dev)
    tk, tr = TH.hash_build(keys, ok, 128)
    assert TH.packed_of(tk, tr) is not None
    TH.check_table(tk, tr, keys, ok)
    probe = torch.cat([keys, keys + 1])
    pok = torch.ones(200, dtype=torch.bool, device=dev)
    want = TH.hash_probe_unique_plain(tk, tr, probe, pok)
    ri, m = TH.hash_probe_unique(tk, tr, probe, pok)
    assert torch.equal(ri, want[0]) and torch.equal(m, want[1])
    assert bool(m[:100].all()) and not bool(m[100:].any())
    assert torch.equal(ri[:100].cpu(), torch.arange(100))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_probe_packs_only_separate_planes(dev, dtype, monkeypatch):
    keys, ok, probe, pok = _inputs(7, dtype, 1 << 12, 0.5)
    k, o = torch.from_numpy(keys).to(dev), torch.from_numpy(ok).to(dev)
    p, po = torch.from_numpy(probe).to(dev), torch.from_numpy(pok).to(dev)
    tk, tr = TH.hash_build(k, o, 1 << 12)
    pk, pr = TH.hash_build_plain(k, o, 1 << 12)
    want = TH.hash_probe_unique_plain(pk, pr, p, po)
    packs = []
    real = TH.pack_table
    monkeypatch.setattr(TH, "pack_table",
                        lambda *a: packs.append(1) or real(*a))
    ri, m = TH.hash_probe_unique(tk, tr, p, po)
    assert packs == []  # the views' own packed table
    assert torch.equal(ri, want[0]) and torch.equal(m, want[1])
    ri, m = TH.hash_probe_unique(pk, pr, p, po)
    assert packs == [1]  # two planes, packed once
    assert torch.equal(ri, want[0]) and torch.equal(m, want[1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_build_and_probe_replay_in_a_graph(dev, dtype):
    T = 1 << 14
    keys, ok, probe, pok = _inputs(4, dtype, T, 0.5)
    k, o = torch.from_numpy(keys).to(dev), torch.from_numpy(ok).to(dev)
    p, po = torch.from_numpy(probe).to(dev), torch.from_numpy(pok).to(dev)
    want = TH.hash_join_unique(p, po, k, o, T)  # eager first
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        tk, tr, overflow = TH._build_kernel(k, o, T)
        out = TH._probe_kernel(tk, tr, p, po)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert int(overflow.item()) == 0
        TH.check_table(tk, tr, k, o)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("T", [1, 128, 1 << 16])
def test_fill_equals_plain(dev, dtype, T):
    want = TH.empty_table(T, dtype, dev)  # the fill's plain version
    for n in (0, 5):  # no rows; dead rows only
        keys = torch.arange(n, dtype=dtype, device=dev)
        tk, tr = TH.hash_build(keys, torch.zeros(n, dtype=torch.bool,
                                                 device=dev), T)
        packed = TH.packed_of(tk, tr)
        assert packed is not None and torch.equal(packed, want)
