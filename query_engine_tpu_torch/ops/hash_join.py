"""Open-addressing hash join: build and probe, the hand-written CUDA kernels
and their plain versions.

Counterpart of `query_engine_tpu/ops/hash_join.py`. The build places each
live build row of a UNIQUE key plane in a power-of-two table by linear
probing from its key's hash; the probe walks each probe row's sequence
until an empty slot (no match) or its key (the match). NULL keys never
match: callers fold validity into `ok`.

  * `hash_build(keys, ok, table_size)` -> (t_keys [T] of the key dtype,
    zeros where empty; t_rows [T] int32, EMPTY where empty).
  * `hash_probe_unique(t_keys, t_rows, probe_keys, ok)` -> (ri [n] int64,
    the build row, 0 where unmatched; matched [n] bool): the contract of
    `kernels.fk_join_right_lookup`.
  * `hash_join_unique(probe_keys, probe_ok, build_keys, build_ok, T)`:
    build, then probe.

Keys are int32 or int64. The hash is the JAX package's: murmur3's
finalizer on uint32 lanes, a 64-bit key's two words mixed apart.

The table lies in one packed tensor, a slot's key and row side by side, so
that the card's probe reads a slot with one load (`csrc/hash_join.cu`):
int64 keys in an int64 [T, 2] (the key; the row in the low word of the
second column, 0 in its high word), int32 keys in an int32 [T, 2] (key,
row); an empty slot holds (0, EMPTY) (`empty_table`, the plain version of
the build kernel's fill). `hash_build` returns (t_keys, t_rows) as
strided views of it (`table_views`), on either device, so every caller
sees two planes; `packed_of` recovers the packed tensor from such views,
and `pack_table` packs two separate planes (one copy). On a CUDA tensor
`hash_probe_unique` launches on the views' packed tensor, or packs
separate planes once and then launches.

The plain versions repeat the JAX package's rounds as torch ops (a host
read a round) on separate planes: each round every unplaced row proposes
its next slot if it is empty, the smallest row id wins the slot, and every
unplaced row that did not win moves one slot on. On the CPU their tables
are the JAX package's, slot for slot (`hash_build` returns them packed).
The kernels place rows with atomicCAS, so the card's layout can differ
from the plain one and from run to run; what holds is what `check_table`
checks (the same entries, each on its own probe sequence with no empty
slot before it), and the probe's results are the same.

A table too small for its live rows (more live rows than slots) raises
ValueError, where the JAX package loops forever. A probe that has walked
all T slots of a full table without finding its key is unmatched.

Which version runs is decided by the device of the tensors, nothing else:
on a CUDA tensor the kernel runs (built at first use by ops/_build.py), or
the call raises; on a CPU tensor the plain version runs.

`launches` counts each kernel's launches in this process.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

EMPTY = 2**31 - 1  # INT32_MAX: t_rows of an empty slot
_M32 = 0xFFFFFFFF
KEY_DTYPES = (torch.int32, torch.int64)

launches = {"hash_build": 0, "hash_probe": 0}


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 lanes x in [0, 2^32): the constant in
    16-bit halves, so that no product reaches 2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64 lanes."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _hash_key(key: torch.Tensor) -> torch.Tensor:
    """Key plane -> its uint32 hash in int64 lanes. A negative int32 key
    hashes as its two's complement; an int64 key as its low word mixed, xor
    its high word xor 0x9E3779B9 mixed."""
    if key.dtype == torch.int64:
        lo = key & _M32
        hi = (key >> 32) & _M32
        return _mix32(lo) ^ _mix32(hi ^ 0x9E3779B9)
    return _mix32(key.to(torch.int64) & _M32)


def table_size_for(n_rows: int, load: float = 0.5) -> int:
    """The smallest power of two >= 128 with `t * load >= n_rows`."""
    t = 128
    while t * load < n_rows:
        t *= 2
    return t


def _check_keys(name: str, keys: torch.Tensor, ok: torch.Tensor):
    if keys.dtype not in KEY_DTYPES:
        raise ValueError(f"{name} keys must be int32 or int64, got "
                         f"{keys.dtype}")
    if keys.dim() != 1 or ok.shape != keys.shape or ok.dtype != torch.bool:
        raise ValueError(f"{name}: keys {tuple(keys.shape)} and ok "
                         f"{tuple(ok.shape)} {ok.dtype} must be one bool "
                         "plane a key")
    if keys.shape[0] >= EMPTY:
        raise ValueError(f"{name}: {keys.shape[0]} rows; row ids must stay "
                         f"below {EMPTY}")
    if ok.device != keys.device:
        raise ValueError(f"{name}: keys on {keys.device}, ok on {ok.device}")


def _check_table_size(table_size: int):
    if not 0 < table_size <= 2**31 or table_size & (table_size - 1):
        raise ValueError(f"table_size {table_size} must be a power of two "
                         "in [1, 2^31]")


def _too_small(n_live, table_size: int) -> ValueError:
    return ValueError(f"a hash table of {table_size} slots is too small for "
                      f"{n_live} live build rows")


def hash_build_plain(keys: torch.Tensor, ok: torch.Tensor, table_size: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's placement rounds as torch ops (any device)."""
    dev = keys.device
    mask = table_size - 1
    h = _hash_key(keys)
    rows = torch.arange(keys.shape[0], dtype=torch.int32, device=dev)
    # slot table_size takes the proposals and keys that are dropped
    t_rows = torch.full((table_size + 1,), EMPTY, dtype=torch.int32,
                        device=dev)
    t_keys = torch.zeros(table_size + 1, dtype=keys.dtype, device=dev)
    placed = torch.zeros_like(ok)
    off = torch.zeros(keys.shape[0], dtype=torch.int64, device=dev)
    # a row still unplaced after table_size rounds has found every slot
    # taken by another row
    for _ in range(table_size + 1):
        active = ok & ~placed
        if not bool(active.any()):
            return t_keys[:table_size], t_rows[:table_size]
        slot = (h + off) & mask
        # propose only into empty slots: a placement is never stolen
        propose = active & (t_rows[slot] == EMPTY)
        cand = torch.where(propose, slot, table_size)
        t_rows.scatter_reduce_(0, cand, rows, reduce="amin",
                               include_self=True)
        won = propose & (t_rows[slot] == rows)
        t_keys.scatter_(0, torch.where(won, slot, table_size), keys)
        placed = placed | won
        off = torch.where(active & ~won, off + 1, off)
    raise _too_small(int(ok.sum()), table_size)


def hash_probe_unique_plain(t_keys: torch.Tensor, t_rows: torch.Tensor,
                            probe_keys: torch.Tensor, ok: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's lockstep probe walk as torch ops (any device)."""
    table_size = t_keys.shape[0]
    mask = table_size - 1
    h = _hash_key(probe_keys)
    active = ok.clone()
    off = torch.zeros(probe_keys.shape[0], dtype=torch.int64,
                      device=probe_keys.device)
    ri = torch.zeros_like(off)
    matched = torch.zeros_like(ok)
    for _ in range(table_size):
        if not bool(active.any()):
            break
        slot = (h + off) & mask
        tr = t_rows[slot]
        empty = tr == EMPTY
        hit = active & ~empty & (t_keys[slot] == probe_keys)
        ri = torch.where(hit, tr.to(torch.int64), ri)
        matched = matched | hit
        active = active & ~empty & ~hit
        off = torch.where(active, off + 1, off)
    return torch.where(matched, ri, 0), matched


# -- the packed table ----------------------------------------------------


def pack_table(t_keys: torch.Tensor, t_rows: torch.Tensor) -> torch.Tensor:
    """The packed table of the planes (t_keys, t_rows), in one copy: int64
    [T, 2] for int64 keys (the row widened, so 0 in its high word), int32
    [T, 2] for int32 keys."""
    rows = t_rows.to(t_keys.dtype)
    return torch.stack([t_keys, rows], dim=1)


def table_views(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_keys [T] of the key dtype, t_rows [T] int32): strided views of a
    packed table. An int64 table's rows are the low words of its second
    column (little-endian: word 2 of the slot's four)."""
    if packed.dtype == torch.int64:
        return packed[:, 0], packed.view(torch.int32)[:, 2]
    return packed[:, 0], packed[:, 1]


def packed_of(t_keys: torch.Tensor, t_rows: torch.Tensor
              ) -> Optional[torch.Tensor]:
    """The packed table whose `table_views` are (t_keys, t_rows), or None
    where the two are not such views (separate planes, a view shifted off
    the storage's start, other strides)."""
    if t_keys.dtype not in KEY_DTYPES or t_rows.dtype != torch.int32 \
            or t_keys.dim() != 1 or t_rows.shape != t_keys.shape \
            or t_rows.device != t_keys.device:
        return None
    rows_at, rows_stride = (2, 4) if t_keys.dtype == torch.int64 else (1, 2)
    storage = t_keys.untyped_storage()
    T = t_keys.shape[0]
    if t_keys.storage_offset() != 0 or t_keys.stride() != (2,) \
            or t_rows.storage_offset() != rows_at \
            or t_rows.stride() != (rows_stride,) \
            or t_rows.untyped_storage().data_ptr() != storage.data_ptr() \
            or storage.nbytes() < 2 * T * t_keys.element_size():
        return None
    return t_keys.as_strided((T, 2), (2, 1), 0)


def empty_table(table_size: int, dtype: torch.dtype, device
                ) -> torch.Tensor:
    """A packed table of `table_size` empty slots, (0, EMPTY) each: the
    plain version of the build kernel's fill."""
    table = torch.full((table_size, 2), EMPTY, dtype=dtype, device=device)
    table[:, 0] = 0
    return table


# -- the kernels' launches -----------------------------------------------


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _build_kernel(keys: torch.Tensor, ok: torch.Tensor, table_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch `qe_hash_build` on the current CUDA stream: it fills a new
    packed table with empty slots, then places the live rows. Returns
    (t_keys, t_rows, overflow): the table's views, and overflow [1] int32,
    1 on the card where some live row found no slot, read by the
    caller."""
    from query_engine_tpu_torch.ops._build import load_library

    if keys.device.type != "cuda":
        raise ValueError(f"the hash build kernel needs CUDA tensors, got "
                         f"{keys.device}")
    keys, ok = keys.contiguous(), ok.contiguous()
    dev = keys.device
    table = torch.empty((table_size, 2), dtype=keys.dtype, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    n = keys.shape[0]
    lib = load_library().lib
    with torch.cuda.device(dev):
        rc = lib.qe_hash_build(keys.data_ptr(), ok.data_ptr(), n,
                               keys.element_size(), table.data_ptr(),
                               table_size, overflow.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"qe_hash_build failed: cudaError {rc}")
    launches["hash_build"] += 1
    return (*table_views(table), overflow)


def _probe_kernel(t_keys: torch.Tensor, t_rows: torch.Tensor,
                  probe_keys: torch.Tensor, ok: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `qe_hash_probe` on the current CUDA stream, on the packed
    table of which (t_keys, t_rows) are views, or on the packing of two
    separate planes."""
    from query_engine_tpu_torch.ops._build import load_library

    dev = probe_keys.device
    if dev.type != "cuda" or t_keys.device != dev or t_rows.device != dev:
        raise ValueError(f"the hash probe kernel needs the table and the "
                         f"probe keys on one CUDA device, got {t_keys.device}"
                         f", {t_rows.device} and {dev}")
    table = packed_of(t_keys, t_rows)
    if table is None or table.data_ptr() % 16:  # the kernel's vector loads
        table = pack_table(t_keys, t_rows)
    probe_keys, ok = probe_keys.contiguous(), ok.contiguous()
    n = probe_keys.shape[0]
    ri = torch.empty(n, dtype=torch.int64, device=dev)
    matched = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return ri, matched
    lib = load_library().lib
    with torch.cuda.device(dev):
        rc = lib.qe_hash_probe(table.data_ptr(), table.shape[0],
                               probe_keys.data_ptr(), ok.data_ptr(), n,
                               probe_keys.element_size(), ri.data_ptr(),
                               matched.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"qe_hash_probe failed: cudaError {rc}")
    launches["hash_probe"] += 1
    return ri, matched


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on several devices: "
                         f"{[str(t.device) for t in tensors]}")
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"no hash join implementation for device "
                         f"{tensors[0].device}")
    return False


def hash_build(keys: torch.Tensor, ok: torch.Tensor, table_size: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The open-addressed table of the live rows of a unique key plane, as
    views of one packed table (see the module docstring). Raises
    ValueError where `table_size` slots cannot hold the live rows."""
    _check_keys("build", keys, ok)
    _check_table_size(table_size)
    if _on_cpu(keys, ok):
        return table_views(pack_table(*hash_build_plain(keys, ok,
                                                        table_size)))
    t_keys, t_rows, overflow = _build_kernel(keys, ok, table_size)
    if int(overflow.item()):
        raise _too_small(int(ok.sum()), table_size)
    return t_keys, t_rows


def _check_probe(t_keys, t_rows, probe_keys, ok):
    _check_keys("probe", probe_keys, ok)
    _check_table_size(t_keys.shape[0])
    if t_keys.dtype != probe_keys.dtype or t_rows.dtype != torch.int32 \
            or t_rows.shape != t_keys.shape:
        raise ValueError(f"table ({t_keys.dtype} {tuple(t_keys.shape)}, "
                         f"{t_rows.dtype} {tuple(t_rows.shape)}) does not "
                         f"take {probe_keys.dtype} probe keys")


def hash_probe_unique(t_keys: torch.Tensor, t_rows: torch.Tensor,
                      probe_keys: torch.Tensor, ok: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each probe row's build row (unique build keys: one match at most):
    (ri int64, 0 where unmatched; matched bool)."""
    _check_probe(t_keys, t_rows, probe_keys, ok)
    if _on_cpu(t_keys, t_rows, probe_keys, ok):
        return hash_probe_unique_plain(t_keys, t_rows, probe_keys, ok)
    return _probe_kernel(t_keys, t_rows, probe_keys, ok)


def hash_join_unique(probe_keys: torch.Tensor, probe_ok: torch.Tensor,
                     build_keys: torch.Tensor, build_ok: torch.Tensor,
                     table_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build, then probe. On the card the two launches run back to back
    and the build's overflow flag is read once, after the probe."""
    _check_keys("build", build_keys, build_ok)
    _check_table_size(table_size)
    if build_keys.dtype != probe_keys.dtype:
        raise ValueError(f"build keys {build_keys.dtype}, probe keys "
                         f"{probe_keys.dtype}")
    _check_keys("probe", probe_keys, probe_ok)
    if _on_cpu(probe_keys, probe_ok, build_keys, build_ok):
        t_keys, t_rows = hash_build_plain(build_keys, build_ok, table_size)
        return hash_probe_unique_plain(t_keys, t_rows, probe_keys, probe_ok)
    t_keys, t_rows, overflow = _build_kernel(build_keys, build_ok,
                                             table_size)
    out = _probe_kernel(t_keys, t_rows, probe_keys, probe_ok)
    if int(overflow.item()):
        raise _too_small(int(build_ok.sum()), table_size)
    return out


def check_table(t_keys: torch.Tensor, t_rows: torch.Tensor,
                keys: torch.Tensor, ok: torch.Tensor) -> None:
    """Raises ValueError unless (t_keys, t_rows) is a table of the live rows
    of (keys, ok) that the probe reads right, in any placement order: the
    occupied slots hold each live row once with its key, empty slots hold
    (0, EMPTY), and every entry lies on its own key's probe sequence with
    no empty slot between its home slot and itself. Runs on the CPU."""
    t_keys, t_rows, keys, ok = (t.cpu() for t in (t_keys, t_rows, keys, ok))
    T = t_keys.shape[0]
    occ = t_rows != EMPTY
    rows = t_rows[occ].to(torch.int64)
    live = torch.nonzero(ok).flatten()
    if not torch.equal(torch.sort(rows).values, live):
        raise ValueError(f"the table's {rows.shape[0]} rows are not the "
                         f"{live.shape[0]} live rows")
    if not torch.equal(t_keys[occ], keys[rows]):
        raise ValueError("an occupied slot holds another row's key")
    if bool((t_keys[~occ] != 0).any()):
        raise ValueError("an empty slot holds a key other than 0")
    if bool(occ.all()) or rows.shape[0] == 0:
        return
    slots = torch.arange(T)
    # the last empty slot at or before each slot, cyclically
    last = torch.where(~occ, slots, -1).cummax(0).values
    last_empty = int(slots[~occ][-1])
    last = torch.where(last < 0, last_empty - T, last)
    home = _hash_key(keys[rows]) & (T - 1)
    dist = (slots[occ] - home) & (T - 1)
    gap = slots[occ] - last[occ] - 1  # occupied slots before it in its run
    bad = dist > gap
    if bool(bad.any()):
        s = int(slots[occ][bad][0])
        raise ValueError(f"slot {s} (row {int(t_rows[s])}) lies "
                         f"{int(dist[bad][0])} slots past its home, past an "
                         f"empty slot")
