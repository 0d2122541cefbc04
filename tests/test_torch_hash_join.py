"""The open-addressing hash join of the port against the JAX package's.

`query_engine_tpu_torch.ops.hash_join` against `query_engine_tpu.ops.
hash_join` on the same seeded numpy inputs, on the CPU (where the port runs
its plain versions): every case of `tests/test_hash_join.py`, then int32
and int64 keys (negative keys, key 0 and the int32 extremes among them,
dead rows among the live ones) at load 0.5 and about 0.85 and three table
sizes up to 2^15 slots. The built table (`t_keys`, `t_rows`) must equal
JAX's slot for slot, and the probe's (ri, matched) must equal JAX's (the
port's ri is int64) and a dict of the live build keys.

`hash_build` returns its table as views of one packed tensor (the
card's layout: a slot's key and row side by side), so these comparisons go
through the views.

Also: `check_table`, the invariant the card's layout is held to (the
card tests reuse it), passes on every plain table and on tables placed in
another order, and catches broken tables, as separate planes and as views
of a packed table; a table too small for its live rows raises ValueError
(the JAX package loops forever there); a probe of a full table for a
missing key is unmatched; the dispatch raises on devices and dtypes it
does not take, and launches no kernel on the CPU. The packed layout's
helpers: `pack_table` and `table_views` round trip, `packed_of`
recognises views of one packed tensor and nothing else, `empty_table`
holds (0, EMPTY) in every slot, and the plain probe gives the same results
on views and on separate planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import query_engine_tpu  # noqa: F401  (enables x64)
from query_engine_tpu.ops import hash_join as JH
from query_engine_tpu_torch.ops import hash_join as TH

_jit_build = jax.jit(JH.hash_build, static_argnums=2)
_jit_probe = jax.jit(JH.hash_probe_unique)


def _jax(bkeys, bok, pkeys, pok, T):
    jk, jr = _jit_build(jnp.asarray(bkeys), jnp.asarray(bok), T)
    ri, m = _jit_probe(jk, jr, jnp.asarray(pkeys), jnp.asarray(pok))
    return (np.asarray(jk), np.asarray(jr)), (np.asarray(ri), np.asarray(m))


def _port(bkeys, bok, pkeys, pok, T):
    tb = torch.from_numpy(bkeys)
    tk, tr = TH.hash_build(tb, torch.from_numpy(bok), T)
    assert TH.packed_of(tk, tr) is not None  # views of one packed table
    TH.check_table(tk, tr, tb, torch.from_numpy(bok))
    ri, m = TH.hash_probe_unique(tk, tr, torch.from_numpy(pkeys),
                                 torch.from_numpy(pok))
    assert ri.dtype == torch.int64 and m.dtype == torch.bool
    joined = TH.hash_join_unique(torch.from_numpy(pkeys),
                                 torch.from_numpy(pok), tb,
                                 torch.from_numpy(bok), T)
    assert torch.equal(joined[0], ri) and torch.equal(joined[1], m)
    return (tk.numpy(), tr.numpy()), (ri.numpy(), m.numpy())


def _oracle(bkeys, bok, pkeys, pok):
    lookup = {int(k): i for i, k in enumerate(bkeys) if bok[i]}
    hit = [bool(o) and int(k) in lookup for k, o in zip(pkeys, pok)]
    ri = [lookup[int(k)] if h else 0 for k, h in zip(pkeys, hit)]
    return np.asarray(ri, np.int64), np.asarray(hit, bool)


def _both(bkeys, bok, pkeys, pok, T):
    """Port and JAX on the same inputs: tables and probe results equal,
    and equal to the dict oracle."""
    bok = np.asarray(bok, bool)
    pok = np.asarray(pok, bool)
    (jk, jr), (jri, jm) = _jax(bkeys, bok, pkeys, pok, T)
    (tk, tr), (ri, m) = _port(bkeys, bok, pkeys, pok, T)
    assert tk.dtype == jk.dtype and np.array_equal(tk, jk)
    assert tr.dtype == np.int32 and np.array_equal(tr, jr)
    assert np.array_equal(m, jm) and np.array_equal(ri, jri.astype(np.int64))
    want_ri, want_m = _oracle(bkeys, bok, pkeys, pok)
    assert np.array_equal(m, want_m) and np.array_equal(ri, want_ri)
    return ri, m


# -- the cases of tests/test_hash_join.py ---------------------------------


def _case_basic_hits_and_misses():
    rng = np.random.default_rng(1)
    bkeys = rng.choice(1 << 40, 2000, replace=False)
    hits = rng.choice(bkeys, 3000)
    misses = rng.integers(1 << 41, 1 << 42, 1000)
    pkeys = np.concatenate([hits, misses])
    rng.shuffle(pkeys)
    return bkeys, None, pkeys, None, TH.table_size_for(2000)


def _case_i32_and_negative_keys():
    bkeys = np.array([-5, -1, 0, 3, 7, 2**31 - 1, -(2**31)], np.int32)
    pkeys = np.array([0, -5, 100, 2**31 - 1, -(2**31), 4], np.int32)
    return bkeys, None, pkeys, None, TH.table_size_for(7)


def _case_probe_ok_mask_excludes_rows():
    return (np.array([1, 2, 3], np.int64), None,
            np.array([1, 2, 3, 1], np.int64),
            np.array([True, False, True, True]), TH.table_size_for(3))


def _case_adversarial_same_slot_cluster():
    bkeys = np.arange(100, dtype=np.int64) * 4096
    return bkeys, None, bkeys, None, 128


def _case_build_then_probe_separately():
    return (np.array([10, 20, 30, 40], np.int64), None,
            np.array([20, 99], np.int64), None, 128)


REFERENCE_CASES = {
    "basic_hits_and_misses": _case_basic_hits_and_misses,
    "i32_and_negative_keys": _case_i32_and_negative_keys,
    "probe_ok_mask_excludes_rows": _case_probe_ok_mask_excludes_rows,
    "adversarial_same_slot_cluster": _case_adversarial_same_slot_cluster,
    "build_then_probe_separately": _case_build_then_probe_separately,
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_case(case):
    bkeys, bok, pkeys, pok, T = REFERENCE_CASES[case]()
    bok = np.ones(len(bkeys), bool) if bok is None else bok
    pok = np.ones(len(pkeys), bool) if pok is None else pok
    ri, m = _both(bkeys, bok, pkeys, pok, T)
    if case == "probe_ok_mask_excludes_rows":
        assert m.tolist() == [True, False, True, True]
    if case == "adversarial_same_slot_cluster":
        assert m.all() and np.array_equal(ri, np.arange(100))
    if case == "build_then_probe_separately":
        assert m.tolist() == [True, False] and ri[0] == 1


@pytest.mark.parametrize("n,load", [(0, 0.5), (64, 0.5), (65, 0.5),
                                    (1 << 20, 0.5), (1000, 0.85),
                                    (1 << 14, 0.85), (3, 0.01)])
def test_table_size_for(n, load):
    assert TH.table_size_for(n, load) == JH.table_size_for(n, load)
    t = TH.table_size_for(n, load)
    assert t >= 128 and t & (t - 1) == 0 and t * load >= n


# -- seeded inputs at three sizes ------------------------------------------


def _seeded(rng, dtype, T, load):
    """Unique build keys (a third negative, key 0 and for int32 both
    extremes among them), about `load * T` live rows among dead ones and 5
    pad rows; probe keys half hits, a quarter dead build rows' keys and a
    quarter absent, 2 % of probe rows not ok."""
    n_live = int(load * T)
    cap = n_live + n_live // 30 + 5
    lo, hi = (-(2**31), 2**31) if dtype == np.int32 else (-(2**47), 2**47)
    bkeys = np.unique(rng.integers(lo, hi, cap * 2))
    bkeys = bkeys[~np.isin(bkeys, [0, -1, 1, -(2**31), 2**31 - 1])]
    rng.shuffle(bkeys)
    bkeys = bkeys[:cap].astype(dtype)
    bkeys[:3] = 0, -1, 1
    if dtype == np.int32:
        bkeys[3:5] = -(2**31), 2**31 - 1
    bok = np.zeros(cap, bool)
    bok[rng.permutation(cap - 5)[:n_live]] = True
    n_probe = 2 * cap
    pkeys = np.concatenate([
        rng.choice(bkeys[bok], n_probe // 2),
        rng.choice(bkeys[~bok], n_probe // 4),
        rng.integers(lo, hi, n_probe - n_probe // 2 - n_probe // 4),
    ]).astype(dtype)
    rng.shuffle(pkeys)
    pok = rng.random(n_probe) >= 0.02
    return bkeys, bok, pkeys, pok


SEEDED = [(dtype, T, load) for dtype in (np.int32, np.int64)
          for load, sizes in ((0.5, (1 << 9, 1 << 12, 1 << 15)),
                              (0.85, (1 << 9, 1 << 12, 1 << 14)))
          for T in sizes]


@pytest.mark.parametrize("dtype,T,load", SEEDED,
                         ids=[f"{np.dtype(d).name}-T{T}-load{load}"
                              for d, T, load in SEEDED])
def test_seeded_tables_and_probe_equal_jax(dtype, T, load):
    rng = np.random.default_rng(T * 7 + int(load * 100)
                                + (dtype == np.int64))
    bkeys, bok, pkeys, pok = _seeded(rng, dtype, T, load)
    _, m = _both(bkeys, bok, pkeys, pok, T)
    assert 0 < m.sum() < len(m)


# -- the invariant checker -------------------------------------------------


def _placed_in_order(keys, ok, T, order):
    """A table placed one row at a time in `order` (what the card's atomic
    placement can give): each row takes the first empty slot of its
    sequence."""
    h = TH._hash_key(torch.from_numpy(keys)).numpy()
    t_keys = np.zeros(T, keys.dtype)
    t_rows = np.full(T, TH.EMPTY, np.int32)
    for r in order:
        if not ok[r]:
            continue
        s = int(h[r]) & (T - 1)
        while t_rows[s] != TH.EMPTY:
            s = (s + 1) & (T - 1)
        t_keys[s], t_rows[s] = keys[r], r
    return torch.from_numpy(t_keys), torch.from_numpy(t_rows)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_another_placement_order_passes_and_probes_alike(dtype):
    rng = np.random.default_rng(5)
    T = 1 << 10
    bkeys, bok, pkeys, pok = _seeded(rng, dtype, T, 0.85)
    tb, tbok = torch.from_numpy(bkeys), torch.from_numpy(bok)
    plain = TH.hash_build(tb, tbok, T)
    tp, tpok = torch.from_numpy(pkeys), torch.from_numpy(pok)
    want = TH.hash_probe_unique(*plain, tp, tpok)
    for seed in range(3):
        order = np.random.default_rng(seed).permutation(len(bkeys))
        tk, tr = _placed_in_order(bkeys, bok, T, order)
        assert not torch.equal(tr, plain[1])  # another layout
        TH.check_table(tk, tr, tb, tbok)
        ri, m = TH.hash_probe_unique(tk, tr, tp, tpok)
        assert torch.equal(ri, want[0]) and torch.equal(m, want[1])


def _broken_tables(tk, tr, keys):
    """(name, t_keys, t_rows) each breaking one invariant."""
    occ = torch.nonzero(tr != TH.EMPTY).flatten()
    empty = torch.nonzero(tr == TH.EMPTY).flatten()
    out = []
    k, r = tk.clone(), tr.clone()  # an entry dropped
    k[occ[0]], r[occ[0]] = 0, TH.EMPTY
    out.append(("dropped", k, r))
    k, r = tk.clone(), tr.clone()  # a row twice
    k[empty[0]], r[empty[0]] = tk[occ[0]], tr[occ[0]]
    out.append(("twice", k, r))
    k, r = tk.clone(), tr.clone()  # another row's key
    k[occ[0]] = keys[int(tr[occ[1]])]
    out.append(("wrong key", k, r))
    k, r = tk.clone(), tr.clone()  # an empty slot with a key
    k[empty[0]] = 7
    out.append(("empty with a key", k, r))
    # an entry moved past an empty slot on its sequence: a row at its home
    # slot moved to the empty slot after the next empty one
    h = TH._hash_key(keys[tr[occ].long()]) & (tr.shape[0] - 1)
    s = int(occ[h == occ][0])
    e = [int(x) for x in empty if int(x) > s]
    k, r = tk.clone(), tr.clone()
    k[e[1]], r[e[1]] = tk[s], tr[s]
    k[s], r[s] = 0, TH.EMPTY
    out.append(("past an empty slot", k, r))
    return out


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_check_table_catches_broken_tables(dtype):
    rng = np.random.default_rng(11)
    T = 1 << 9
    bkeys, bok, _, _ = _seeded(rng, dtype, T, 0.5)
    tb, tbok = torch.from_numpy(bkeys), torch.from_numpy(bok)
    tk, tr = TH.hash_build(tb, tbok, T)
    TH.check_table(tk, tr, tb, tbok)
    for name, k, r in _broken_tables(tk, tr, tb):
        with pytest.raises(ValueError):
            TH.check_table(k, r, tb, tbok)
            pytest.fail(name)


# -- edges -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_too_small_table_raises(dtype):
    keys = torch.arange(200, dtype=dtype) * 3 - 100
    ok = torch.ones(200, dtype=torch.bool)
    with pytest.raises(ValueError, match="too small"):
        TH.hash_build(keys, ok, 128)
    with pytest.raises(ValueError, match="too small"):
        TH.hash_join_unique(keys, ok, keys, ok, 128)
    # 128 live rows of the 200 fill the table and build
    ok[128:] = False
    tk, tr = TH.hash_build(keys, ok, 128)
    assert bool((tr != TH.EMPTY).all())
    TH.check_table(tk, tr, keys, ok)


def test_full_table_probe_misses_an_absent_key():
    keys = torch.arange(128, dtype=torch.int64) * 4096
    ok = torch.ones(128, dtype=torch.bool)
    tk, tr = TH.hash_build(keys, ok, 128)
    probe = torch.tensor([4096 * 5, 1, -1, 4096 * 127])
    ri, m = TH.hash_probe_unique(tk, tr, probe, torch.ones(4, dtype=bool))
    assert m.tolist() == [True, False, False, True]
    assert ri.tolist() == [5, 0, 0, 127]


def test_empty_inputs():
    e = torch.zeros(0, dtype=torch.int64)
    eok = torch.zeros(0, dtype=torch.bool)
    tk, tr = TH.hash_build(e, eok, 128)
    assert bool((tr == TH.EMPTY).all()) and bool((tk == 0).all())
    ri, m = TH.hash_probe_unique(tk, tr, e, eok)
    assert ri.shape == (0,) and m.shape == (0,)
    # key 0 never matches an empty slot
    ri, m = TH.hash_probe_unique(tk, tr, torch.zeros(3, dtype=torch.int64),
                                 torch.ones(3, dtype=torch.bool))
    assert not m.any() and not ri.any()


def test_dispatch_raises_and_launches_nothing_on_the_cpu():
    keys = torch.arange(10, dtype=torch.int64)
    ok = torch.ones(10, dtype=torch.bool)
    before = dict(TH.launches)
    TH.hash_join_unique(keys, ok, keys, ok, 128)
    assert TH.launches == before
    with pytest.raises(ValueError, match="int32 or int64"):
        TH.hash_build(keys.double(), ok, 128)
    with pytest.raises(ValueError, match="power of two"):
        TH.hash_build(keys, ok, 96)
    with pytest.raises(ValueError, match="int64"):
        TH.hash_join_unique(keys.int(), ok, keys, ok, 128)
    with pytest.raises(ValueError, match="no hash join implementation"):
        TH.hash_build(keys.to("meta"), ok.to("meta"), 128)
    tk, tr = TH.hash_build(keys, ok, 128)
    with pytest.raises(ValueError, match="devices"):
        TH.hash_probe_unique(tk, tr.to("meta"), keys, ok)
    with pytest.raises(ValueError):
        TH.hash_probe_unique(tk, tr, keys.int(), ok)


# -- the packed table ------------------------------------------------------

KEY_TYPES = [torch.int32, torch.int64]
KEY_IDS = ["int32", "int64"]


def _planes(dtype, T=256, seed=3):
    """Two separate planes in a table's value ranges: keys over the whole
    dtype (negatives and extremes among them), rows in [0, EMPTY]."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    keys = rng.integers(info.min, info.max, T, endpoint=True)
    keys[:2] = info.min, info.max
    rows = rng.integers(0, TH.EMPTY, T, endpoint=True).astype(np.int32)
    rows[:2] = 0, TH.EMPTY
    return torch.from_numpy(keys).to(dtype), torch.from_numpy(rows)


@pytest.mark.parametrize("dtype", KEY_TYPES, ids=KEY_IDS)
def test_pack_table_round_trip(dtype):
    t_keys, t_rows = _planes(dtype)
    packed = TH.pack_table(t_keys, t_rows)
    assert packed.dtype == dtype and packed.shape == (256, 2)
    assert packed.is_contiguous()
    k, r = TH.table_views(packed)
    assert k.dtype == dtype and r.dtype == torch.int32
    assert torch.equal(k, t_keys) and torch.equal(r, t_rows)
    # the views share the packed tensor's storage: a write shows in both
    assert k.untyped_storage().data_ptr() == packed.data_ptr()
    assert r.untyped_storage().data_ptr() == packed.data_ptr()
    r[5] = 77
    k[5] = -9
    assert int(packed[5, 0]) == -9
    if dtype == torch.int64:  # the row in the low word, 0 in the high word
        assert int(packed[5, 1]) == 77
        assert bool((packed[:, 1] >= 0).all())
        assert bool((packed[:, 1] <= TH.EMPTY).all())
    else:
        assert int(packed[5, 1]) == 77
    again = TH.pack_table(k, r)
    assert torch.equal(again, packed)


@pytest.mark.parametrize("dtype", KEY_TYPES, ids=KEY_IDS)
def test_packed_of_recognises_views(dtype):
    packed = TH.pack_table(*_planes(dtype))
    got = TH.packed_of(*TH.table_views(packed))
    assert got is not None and got.data_ptr() == packed.data_ptr()
    assert got.shape == packed.shape and got.stride() == packed.stride()
    assert torch.equal(got, packed)
    # the kernel-less build on the CPU gives such views too
    keys = torch.arange(50, dtype=dtype) * 7 - 20
    tk, tr = TH.hash_build(keys, torch.ones(50, dtype=torch.bool), 128)
    got = TH.packed_of(tk, tr)
    assert got is not None and torch.equal(TH.table_views(got)[0], tk)
    assert torch.equal(TH.table_views(got)[1], tr)


def _not_views(dtype):
    """{name: (t_keys, t_rows)} that are not the views of one packed
    table."""
    t_keys, t_rows = _planes(dtype)
    packed = TH.pack_table(t_keys, t_rows)
    k, r = TH.table_views(packed)
    three = torch.cat([packed, packed[:, :1]], 1)  # [T, 3]
    rows_word = 2 if dtype == torch.int64 else 1
    out = {
        "separate planes": (t_keys.clone(), t_rows.clone()),
        "plain build": TH.hash_build_plain(
            torch.arange(10, dtype=dtype), torch.ones(10, dtype=torch.bool),
            256),
        "shifted": TH.table_views(packed[1:]),
        "rows of another packing": (
            k, TH.table_views(TH.pack_table(t_keys, t_rows))[1]),
        "every other slot": (k[::2], r[::2]),
        "fewer keys than rows": (k[:-1], r),
        "three columns": (three[:, 0],
                          three.view(torch.int32)[:, rows_word]),
        "swapped": (r.to(dtype), k.to(torch.int32)),
    }
    if dtype == torch.int64:  # the high word is not the row
        out["other word"] = (k, packed.view(torch.int32)[:, 3])
    else:  # rows that are not int32
        out["other word"] = (k, TH.pack_table(t_keys, t_rows)[:, 1]
                             .to(torch.int64))
    return out


NOT_VIEWS = ["separate planes", "plain build", "shifted",
             "rows of another packing", "every other slot",
             "fewer keys than rows", "three columns", "swapped",
             "other word"]


@pytest.mark.parametrize("name", NOT_VIEWS)
@pytest.mark.parametrize("dtype", KEY_TYPES, ids=KEY_IDS)
def test_packed_of_rejects(dtype, name):
    k, r = _not_views(dtype)[name]
    assert TH.packed_of(k, r) is None


@pytest.mark.parametrize("dtype", KEY_TYPES, ids=KEY_IDS)
@pytest.mark.parametrize("T", [1, 128, 4096])
def test_empty_table(dtype, T):
    table = TH.empty_table(T, dtype, "cpu")
    assert table.shape == (T, 2) and table.dtype == dtype
    tk, tr = TH.table_views(table)
    assert bool((tk == 0).all()) and bool((tr == TH.EMPTY).all())
    assert TH.packed_of(tk, tr) is not None
    if dtype == torch.int64:
        assert bool((table[:, 1] == TH.EMPTY).all())  # high words 0
    # an empty table of no live rows passes the checker
    keys = torch.zeros(3, dtype=dtype)
    TH.check_table(tk, tr, keys, torch.zeros(3, dtype=torch.bool))


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=KEY_IDS)
@pytest.mark.parametrize("load", [0.5, 0.85])
def test_plain_probe_on_views_equals_planes(dtype, load):
    rng = np.random.default_rng(21 + int(load * 100))
    T = 1 << 10
    bkeys, bok, pkeys, pok = _seeded(rng, dtype, T, load)
    tb, tbok = torch.from_numpy(bkeys), torch.from_numpy(bok)
    planes = TH.hash_build_plain(tb, tbok, T)
    views = TH.hash_build(tb, tbok, T)
    assert TH.packed_of(*planes) is None
    assert TH.packed_of(*views) is not None
    assert torch.equal(views[0], planes[0])
    assert torch.equal(views[1], planes[1])
    tp, tpok = torch.from_numpy(pkeys), torch.from_numpy(pok)
    want = TH.hash_probe_unique_plain(*planes, tp, tpok)
    for table in (views, TH.table_views(TH.pack_table(*planes))):
        got = TH.hash_probe_unique_plain(*table, tp, tpok)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = TH.hash_probe_unique(*table, tp, tpok)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < int(want[1].sum()) < len(pkeys)


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=KEY_IDS)
def test_check_table_catches_broken_packed_tables(dtype):
    rng = np.random.default_rng(12)
    T = 1 << 9
    bkeys, bok, _, _ = _seeded(rng, dtype, T, 0.5)
    tb, tbok = torch.from_numpy(bkeys), torch.from_numpy(bok)
    tk, tr = TH.hash_build(tb, tbok, T)
    TH.check_table(tk, tr, tb, tbok)
    for name, k, r in _broken_tables(tk, tr, tb):
        packed = TH.pack_table(k, r)
        views = TH.table_views(packed)
        assert TH.packed_of(*views) is not None
        with pytest.raises(ValueError):
            TH.check_table(*views, tb, tbok)
            pytest.fail(name)
    # the same entries placed in another order, packed, pass
    order = np.random.default_rng(1).permutation(len(bkeys))
    k, r = _placed_in_order(bkeys, bok, T, order)
    TH.check_table(*TH.table_views(TH.pack_table(k, r)), tb, tbok)
