"""Vectorized operator kernels over fixed-capacity torch planes.

The plain-torch counterparts of the `query_engine_tpu.ops.kernels`
functions that the eager main path and the compiled pipeline call, with the
same names and contracts: every function takes planes at a fixed capacity plus a live-row
count (or a boolean selection mask) and returns planes, so the host reads a
scalar only where an output size depends on the data (count-then-emit).

Differences from the JAX package, all of representation, none of result:
  * index planes (compaction indices, group ids, join emit indices,
    permutations) are int64, torch's index dtype;
  * a multi-operand stable sort is a chain of stable `torch.sort` calls
    from the last key to the first (`_lexsort`);
  * scatters that drop out-of-range targets write into a spill slot at the
    end of an output one element longer, which is then sliced off;
  * packed 32-bit words (gather_columns_packed, fk_gather_by_rank) are
    int64 planes holding values in [0, 2^32); the small-table gather takes
    and gives them as they are, with the int64 index plane
    (`small_gather.gather_word_planes`, one launch);
  * segment counts and sums: on a CUDA tensor every one is a launch of the
    group_agg kernel (ops/group_agg.py), which sums integers exactly and
    floats in fixed point, so they give the same bits on every run (a
    float64 `index_add_` on CUDA uses atomics whose order changes the
    result); on the CPU an int64 or float64 `index_add_`, the JAX
    package's CPU semantics.

Nulls: SQL three-valued logic. Group keys: NULLs group together. Join keys:
NULLs never match (each null row gets a unique negative rank).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import ExecutionError
from query_engine_tpu_torch.ops import group_agg, small_gather

_I32_MIN = int(np.iinfo(np.int32).min)
_I32_MAX = int(np.iinfo(np.int32).max)
_I64_MIN = int(np.iinfo(np.int64).min)
_I64_MAX = int(np.iinfo(np.int64).max)
_F64_QNAN = 0x7FF8000000000000  # the positive quiet NaN's bits
_F32_QNAN = 0x7FC00000

# ---------------------------------------------------------------------------
# small utilities
# ---------------------------------------------------------------------------


def live_mask(capacity: int, num_rows, device="cpu") -> torch.Tensor:
    """Boolean live-row plane. `num_rows` is either a row count (int or 0-d
    tensor) or an explicit boolean selection mask, returned as it is."""
    if isinstance(num_rows, torch.Tensor) and num_rows.dim() == 1 \
            and num_rows.dtype == torch.bool:
        return num_rows
    if isinstance(num_rows, torch.Tensor):
        device = num_rows.device
    return torch.arange(capacity, device=device) < num_rows


def _scatter_drop(size: int, index: torch.Tensor, src, fill, dtype,
                  reduce: Optional[str] = None) -> torch.Tensor:
    """out[index[i]] = src[i] (or reduced with `reduce`) into a `size`-long
    plane initialised to `fill`; targets outside [0, size) are dropped."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=index.device)
    tgt = torch.where((index >= 0) & (index < size), index,
                      torch.full_like(index, size))
    if not isinstance(src, torch.Tensor):
        src = torch.full(index.shape, src, dtype=dtype, device=index.device)
    src = src.to(dtype)
    if reduce is None:
        out.scatter_(0, tgt, src)
    else:
        out.scatter_reduce_(0, tgt, src, reduce=reduce, include_self=True)
    return out[:size]


def _segment_count(ok: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Rows per segment where `ok` (int64); ids outside [0, num_segments)
    are dropped. On the card one group_agg launch that reads only `ok`."""
    return group_agg.grouped_sums_counts_multi(
        [(None, ok)], segment_ids, num_segments)[0][1]


def _lexsort(operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic sort permutation, operands[0] the major key
    (lax.sort(operands + [iota], num_keys=len(operands), is_stable=True))."""
    n = operands[0].shape[0]
    perm = torch.arange(n, device=operands[0].device)
    for key in reversed(list(operands)):
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm


def _f32_orderable_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose signed order matches float order (sign-flip
    trick; the reference uses the same idea for its IndexKey,
    query-index/src/types.rs:101-110)."""
    bits = x.to(torch.float32).view(torch.int32)
    return torch.where(bits < 0, _I32_MIN - bits, bits)


def orderable_i64(data: torch.Tensor) -> torch.Tensor:
    """Normalize a key column to a sortable plane preserving order and
    equality: 32-bit-or-smaller lanes map to int32, int64 stays int64,
    float64 stays float64 (torch sorts it natively)."""
    if data.dtype == torch.float64:
        return data
    if data.is_floating_point():
        return _f32_orderable_bits(data)
    if data.dtype == torch.int64:
        return data
    return data.to(torch.int32)


def from_orderable(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of orderable_i64 for value recovery (min/max results)."""
    if dtype == torch.float64:
        return y
    if dtype == torch.float32:
        bits = torch.where(y < 0, _I32_MIN - y, y).to(torch.int32)
        return bits.view(torch.float32)
    return y


def normalize_key(data: torch.Tensor, validity: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(orderable key, null mask). Null data slots are zeroed so equal nulls
    compare equal; callers add the null plane as a separate key."""
    key = orderable_i64(data)
    null = ~validity
    return torch.where(null, torch.zeros_like(key), key), null


def _u32_image(key: torch.Tensor) -> torch.Tensor:
    """int32 orderable image -> its unsigned 32-bit position as int64."""
    return key.to(torch.int64) - _I32_MIN


# ---------------------------------------------------------------------------
# sort
# ---------------------------------------------------------------------------


def _sort_key_operands(
    key_datas: Sequence[torch.Tensor],
    key_valids: Sequence[torch.Tensor],
    ascs: Sequence[bool],
    nulls_firsts: Sequence[bool],
    pad: torch.Tensor,
) -> List[torch.Tensor]:
    """Sort operands for a multi-key sort with pad rows last. Per key: one
    packed int64 operand when the orderable image is 32-bit, else (class,
    key) pairs; the pad flag rides the first key's class plane (pad class 2
    dominates null classes {0, 1})."""
    operands: List[torch.Tensor] = []
    for i, (data, valid, asc, nf) in enumerate(
        zip(key_datas, key_valids, ascs, nulls_firsts)
    ):
        key, null = normalize_key(data, valid)
        cls = torch.where(null, 0 if nf else 1, 1 if nf else 0)
        if i == 0:
            cls = torch.where(pad, 2, cls)
        if key.dtype == torch.int32:
            # unsigned 32-bit image; desc = reflect within the low word
            u = _u32_image(key)
            if not asc:
                u = (2**32 - 1) - u
            operands.append((cls.to(torch.int64) << 32) | u)
        else:
            if not asc:
                # orderable int64 images of live data never hit INT64_MIN
                key = -key
            operands.append(cls)
            operands.append(key)
    if not operands:  # no keys: pad plane alone orders live-first
        operands.append(pad.to(torch.int32))
    return operands


def _composite_key(key_datas, key_valids, ranges, pad, ascs=None,
                   nulls_firsts=None):
    """ONE int64 sort operand for keys that ALL have static (lo, range)
    covers, when the fields (+1 null bit each, +1 pad bit) fit 63 bits:
    (composite plane, its bit count), or None. Per key, most significant
    first: the null bit, then the clipped code (bit-flipped for DESC); a
    null bit of 1 sorts the null above live values (flipped for NULLS
    FIRST). Without ascs/nulls_firsts: ascending, nulls last (grouping)."""
    if ranges is None or len(ranges) != len(key_datas) or not all(
        r is not None and len(r) == 2 for r in ranges
    ):
        return None
    widths = [max(int(r[1] - 1).bit_length(), 1) for r in ranges]
    total_bits = sum(w + 1 for w in widths) + 1
    if total_bits > 63:
        return None
    n = len(key_datas)
    ascs = ascs or [True] * n
    nulls_firsts = nulls_firsts or [False] * n
    comp = torch.zeros(pad.shape[0], dtype=torch.int64, device=pad.device)
    for data, valid, asc, nf, (lo, _r), w in zip(
        key_datas, key_valids, ascs, nulls_firsts, ranges, widths
    ):
        code = (data.to(torch.int64) - lo).clamp(0, (1 << w) - 1)
        if not asc:
            code = ((1 << w) - 1) - code
        null_bit = valid.to(torch.int64) if nf else (~valid).to(torch.int64)
        comp = ((comp << (w + 1)) | (null_bit << w)
                | torch.where(valid, code, 0))
    return comp | (pad.to(torch.int64) << (total_bits - 1)), total_bits


def sort_permutation(
    key_datas: Sequence[torch.Tensor],
    key_valids: Sequence[torch.Tensor],
    ascs: Sequence[bool],
    nulls_firsts: Sequence[bool],
    num_rows,
    ranges: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
) -> torch.Tensor:
    """Stable multi-key sort permutation: perm[out_pos] = in_row. Live rows
    come first in the requested order; pad rows sink to the end. Ties keep
    input order (Arrow lexsort_to_indices as used by the reference's
    SortedMerge, query-distributed/src/operators.rs:180-193).

    ranges: optional per-key (lo, range) static covers; when every key is
    covered and the fields fit 63 bits, all keys compose into ONE int64
    operand and the sort is one stable torch.sort."""
    capacity = key_datas[0].shape[0]
    pad = ~live_mask(capacity, num_rows, key_datas[0].device)
    comp = _composite_key(key_datas, key_valids, ranges, pad, list(ascs),
                          list(nulls_firsts))
    if comp is not None:
        return torch.sort(comp[0], stable=True).indices
    operands = _sort_key_operands(key_datas, key_valids, ascs,
                                  nulls_firsts, pad)
    return _lexsort(operands)


# ---------------------------------------------------------------------------
# filter / compaction
# ---------------------------------------------------------------------------


def filter_count(mask: torch.Tensor, num_rows) -> torch.Tensor:
    m = mask & live_mask(mask.shape[0], num_rows, mask.device)
    return m.sum(dtype=torch.int64)


def compaction_indices(mask: torch.Tensor, num_rows, out_capacity: int
                       ) -> torch.Tensor:
    """Indices of mask-true live rows, compacted to the front of an
    out_capacity-long index plane (cumsum + scatter: no host sync, unlike
    `nonzero`). Slots past the count hold 0."""
    capacity = mask.shape[0]
    m = mask & live_mask(capacity, num_rows, mask.device)
    pos = torch.cumsum(m.to(torch.int64), 0) - 1
    rows = torch.arange(capacity, device=mask.device)
    return _scatter_drop(out_capacity, torch.where(m, pos, -1), rows, 0,
                         torch.int64)


def gather_columns(
    datas: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    indices: torch.Tensor,
    row_valid: Optional[torch.Tensor] = None,
):
    """Gather rows by index across columns; optional row_valid plane ANDs
    into every column's validity (outer-join null padding)."""
    out_d, out_v = [], []
    for d, v in zip(datas, valids):
        out_d.append(d[indices])
        vv = v[indices]
        if row_valid is not None:
            vv = vv & row_valid
        out_v.append(vv)
    return out_d, out_v


def _word_layout(slots, direct=()):
    """First-fit-decreasing of columns into 32-bit words. slots: (column,
    data bits); every slot carries one more bit for validity; `direct`
    columns add valid-only 1-bit slots. Returns (words: columns per word,
    layout: column -> (word, bit offset, data bits))."""
    items = sorted(
        [(bits + 1, i, bits) for i, bits in slots]
        + [(1, i, 0) for i in direct],
        reverse=True,
    )
    words: List[list] = []
    used: List[int] = []
    layout = {}
    for size, i, bits in items:
        for w in range(len(words)):
            if used[w] + size <= 32:
                layout[i] = (w, used[w], bits)
                words[w].append(i)
                used[w] += size
                break
        else:
            layout[i] = (len(words), 0, bits)
            words.append([i])
            used.append(size)
    return words, layout


def _pack_slot(data, bounds) -> Optional[int]:
    """Data bits of a packable column (bool, or an integer column whose
    static (lo, range) cover fits 30 bits), else None."""
    if data.dtype == torch.bool:
        return 1
    if (
        bounds is not None and len(bounds) == 2
        and not data.is_floating_point()
        and max(int(bounds[1]) - 1, 1).bit_length() <= 30
    ):
        return max(int(bounds[1] - 1).bit_length(), 1)
    return None


def _lo(data, bounds) -> int:
    if data.dtype == torch.bool or bounds is None or len(bounds) != 2:
        return 0
    return int(bounds[0])


def _pack_words(words, layout, datas, valids, bounds, length, device):
    """The packed int64 word planes (values in [0, 2^32))."""
    planes = []
    for members in words:
        plane = torch.zeros(length, dtype=torch.int64, device=device)
        for i in members:
            _, off, bits = layout[i]
            if bits:
                img = (datas[i].to(torch.int64) - _lo(datas[i], bounds[i])) \
                    & ((1 << bits) - 1)
                plane = plane | (img << off)
            plane = plane | (valids[i].to(torch.int64) << (off + bits))
        planes.append(plane)
    return planes


def _unpack(gw, off, bits, data, bounds):
    """Column data from its slot of a gathered word plane."""
    if data.dtype == torch.bool:
        return ((gw >> off) & 1) != 0
    return (((gw >> off) & ((1 << bits) - 1)) + _lo(data, bounds)).to(
        data.dtype)


def gather_columns_packed(
    datas: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    bounds: Sequence[Optional[Tuple[int, int]]],
    indices: torch.Tensor,
    row_valid: Optional[torch.Tensor] = None,
    mxu_small: bool = False,
):
    """gather_columns with bit-packing: columns whose static bounds (table
    stats / dictionary sizes) fit 30 bits pack (data - lo) plus their
    validity bit into shared 32-bit words, and every other column
    contributes its validity bit too, so K columns need fewer than 2K
    gathers.

    bounds[i]: None, or a static (lo, range) cover of column i's live
    values. Pad/garbage rows may lie outside the cover — their packed image
    wraps, which is fine because only rows with a true validity bit are
    ever read downstream.

    mxu_small (the JAX name kept): when the source has at most
    small_gather.MAX_TABLE rows, the words are gathered by the small-table
    gather (`small_gather.gather_word_planes`: on the card one kernel launch
    over the int64 indices and planes, with no conversion around it).
    Indices must be int64 and in range, as for the plain gather.
    """
    n_cols = len(datas)
    slots, direct = [], []
    for i, (d, b) in enumerate(zip(datas, bounds)):
        bits = _pack_slot(d, b)
        if bits is None:
            direct.append(i)
        else:
            slots.append((i, bits))
    if not slots and n_cols <= 1:
        return gather_columns(datas, valids, indices, row_valid)

    words, layout = _word_layout(slots, direct)
    src_len = datas[0].shape[0]
    raw_planes = _pack_words(words, layout, datas, valids, bounds, src_len,
                             indices.device)
    if mxu_small and raw_planes and src_len <= small_gather.MAX_TABLE:
        planes = list(small_gather.gather_word_planes(
            indices, torch.stack(raw_planes)))
    else:
        planes = [p[indices] for p in raw_planes]

    out_d, out_v = [], []
    for i in range(n_cols):
        w, off, bits = layout[i]
        gw = planes[w]
        vv = ((gw >> (off + bits)) & 1) != 0
        if row_valid is not None:
            vv = vv & row_valid
        if bits:
            d = _unpack(gw, off, bits, datas[i], bounds[i])
        else:
            d = datas[i][indices]
        out_d.append(d)
        out_v.append(vv)
    return out_d, out_v


def fk_gather_by_rank(
    datas: Sequence[torch.Tensor],
    valids: Sequence[torch.Tensor],
    bounds: Sequence[Optional[Tuple[int, int]]],
    rr: torch.Tensor,
    r_live: torch.Tensor,
    lr: torch.Tensor,
    l_live: torch.Tensor,
    n_ranks: int,
):
    """FK join emit fused to ONE probe-length gather per packed word: the
    build side's packed words scatter to RANK space (build-side cost), so
    each probe row gathers its rank's word directly. An 'occupied' bit rides
    along, so `matched` comes from the same gathered word.

    Requires every right column to pack (30-bit bounded ints / bools);
    returns (out_datas, out_valids, matched), or None for the caller to use
    fk_join_right_lookup + gather_columns_packed.
    """
    n_cols = len(datas)
    src_len = r_live.shape[0]
    slots = []
    for i, (d, b) in enumerate(zip(datas, bounds)):
        bits = _pack_slot(d, b)
        if bits is None:
            return None
        slots.append((i, bits))
    slots.append((n_cols, 1))  # occupied marker (bool, always valid)
    words, layout = _word_layout(slots)

    dev = rr.device
    all_d = list(datas) + [torch.ones(src_len, dtype=torch.bool, device=dev)]
    all_v = list(valids) + [r_live]
    all_b = list(bounds) + [None]
    r_ok = r_live & (rr >= 0)
    tgt = torch.where(r_ok, rr, n_ranks)
    l_ok = l_live & (lr >= 0)
    src = lr.clamp(0, n_ranks - 1)

    planes = []
    for plane in _pack_words(words, layout, all_d, all_v, all_b, src_len,
                             dev):
        by_rank = _scatter_drop(n_ranks, tgt, plane, 0, torch.int64)
        planes.append(by_rank[src])

    w, off, bits = layout[n_cols]
    matched = l_ok & (((planes[w] >> (off + bits)) & 1) != 0)

    out_d, out_v = [], []
    for i in range(n_cols):
        w, off, bits = layout[i]
        gw = planes[w]
        out_d.append(_unpack(gw, off, bits, all_d[i], all_b[i]))
        out_v.append((((gw >> (off + bits)) & 1) != 0) & matched)
    return out_d, out_v, matched


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


def _segment_ids_from_sorted(
    sorted_keys: Sequence[torch.Tensor], pad_sorted: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boundary flags + segment ids over rows already in sorted order.
    Pad rows all fall into one trailing segment."""
    capacity = pad_sorted.shape[0]
    idx = torch.arange(capacity, device=pad_sorted.device)
    change = idx == 0
    for k in sorted_keys:
        change = change | ((idx > 0) & (k != torch.roll(k, 1)))
    change = change | (pad_sorted & ~torch.roll(pad_sorted, 1))
    seg = torch.cumsum(change.to(torch.int64), 0) - 1
    return change, seg


def group_ids(
    key_datas: Sequence[torch.Tensor],
    key_valids: Sequence[torch.Tensor],
    num_rows,
    ranges: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense group ids for GROUP BY keys (NULLs group together), by a joint
    sort. Returns (group id per row [capacity], num_groups 0-d tensor,
    representative row per group [capacity]). Ids are dense in sorted key
    order.

    ranges: optional per-key static (lo, range) covers; when every key is
    covered and the fields fit 63 bits, the keys compose into ONE int64
    sort operand."""
    capacity = key_datas[0].shape[0]
    device = key_datas[0].device
    pad = ~live_mask(capacity, num_rows, device)
    comp = _composite_key(key_datas, key_valids, ranges, pad)
    if comp is not None:
        comp, total_bits = comp
        sorted_comp, sperm = torch.sort(comp, stable=True)
        sorted_pad = (sorted_comp >> (total_bits - 1)) == 1
        change, seg = _segment_ids_from_sorted([sorted_comp], sorted_pad)
        first = change & ~sorted_pad
        gid = torch.zeros(capacity, dtype=torch.int64, device=device)
        gid[sperm] = seg
        rep = _scatter_drop(capacity, torch.where(first, seg, -1), sperm, 0,
                            torch.int64)
        return gid, first.sum(dtype=torch.int64), rep
    operands: List[torch.Tensor] = []
    for i, (data, valid) in enumerate(zip(key_datas, key_valids)):
        key, null = normalize_key(data, valid)
        cls = null.to(torch.int32)
        if i == 0:
            cls = torch.where(pad, 2, cls)
        if key.dtype == torch.int32:
            operands.append((cls.to(torch.int64) << 32) | _u32_image(key))
        else:
            operands.append(cls)
            operands.append(key)
    sperm = _lexsort(operands)
    sorted_keys = [op[sperm] for op in operands]
    first = sorted_keys[0]
    sorted_pad = (first >> 32) == 2 if first.dtype == torch.int64 \
        else first == 2
    change, seg = _segment_ids_from_sorted(sorted_keys, sorted_pad)
    num_groups = (change & ~sorted_pad).sum(dtype=torch.int64)
    gid = torch.zeros(capacity, dtype=torch.int64, device=device)
    gid[sperm] = seg
    # representative row (first in sorted order) for each group
    rep = _scatter_drop(capacity, torch.where(change & ~sorted_pad, seg, -1),
                        sperm, 0, torch.int64)
    return gid, num_groups, rep


def group_ids_direct(
    key: torch.Tensor,
    valid: torch.Tensor,
    num_rows,
    key_min: int,
    num_buckets: int,
):
    """Sort-free grouping for a single integer key with a bounded range:
    bucket = key - key_min, then densify over observed buckets. Same
    contract and group order as group_ids: ids dense in key order, NULLs
    one trailing group."""
    capacity = key.shape[0]
    device = key.device
    lm = live_mask(capacity, num_rows, device)
    nb = num_buckets + 1  # + null bucket
    bucket = torch.where(
        lm & valid,
        (key.to(torch.int64) - key_min).clamp(0, num_buckets - 1),
        torch.where(lm, num_buckets, nb),  # nulls -> last; pad -> dropped
    )
    counts = _segment_count(lm, bucket.clamp(0, nb - 1), nb)
    observed = counts > 0
    dense = torch.cumsum(observed.to(torch.int64), 0) - 1  # bucket -> id
    num_groups = observed.sum(dtype=torch.int64)
    gid = dense[bucket.clamp(0, nb - 1)]
    gid = torch.where(lm, gid, 0)
    # representative row per dense group: min row index per bucket
    rows = torch.arange(capacity, device=device)
    rep_by_bucket = _scatter_drop(nb, torch.where(lm, bucket, nb), rows,
                                  capacity, torch.int64, reduce="amin")
    rep = _scatter_drop(capacity, torch.where(observed, dense, -1),
                        rep_by_bucket.clamp(max=capacity - 1), 0, torch.int64)
    return gid, num_groups, rep


def key_range(key: torch.Tensor, valid: torch.Tensor, num_rows):
    """(min, max, any_valid) of the live valid key values, as 0-d tensors
    (for the direct grouping path; the caller reads them on the host)."""
    lm = live_mask(key.shape[0], num_rows, key.device) & valid
    big = _I32_MAX if key.dtype == torch.int32 else _I64_MAX
    kmin = torch.where(lm, key, torch.full_like(key, big)).min()
    kmax = torch.where(lm, key, torch.full_like(key, -big - 1)).max()
    return kmin, kmax, lm.any()


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def segment_aggregate(
    func: str,
    data: Optional[torch.Tensor],
    validity: Optional[torch.Tensor],
    gid: torch.Tensor,
    num_rows,
    num_segments: int,
    distinct_first: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One aggregate over segments. Returns (values[num_segments],
    valid[num_segments]).

    func: count_star | count | sum | avg | min | max
    Semantics parity (reference operators.rs:745-848): COUNT ignores nulls
    (COUNT(*) counts rows), SUM/AVG/MIN/MAX ignore nulls and are NULL for
    empty/all-null groups; SUM(int) accumulates in int64 (wrapping), AVG in
    float64. The count, and the sum of SUM and AVG, come from one
    `group_agg.grouped_sums_counts_multi` call: one kernel launch on a
    CUDA tensor (floats in fixed point), int64 and float64 `index_add_`s
    on the CPU.

    distinct_first: the dedup plane of a DISTINCT aggregate
    (`distinct_first_flags`); only the rows it marks are aggregated.
    """
    capacity = gid.shape[0]
    device = gid.device
    lm = live_mask(capacity, num_rows, device)
    ones = torch.ones(num_segments, dtype=torch.bool, device=device)
    if func != "count_star" and (data is None or validity is None):
        raise ValueError(f"aggregate {func} needs a data and validity plane")
    ok = lm if func == "count_star" else lm & validity
    if distinct_first is not None:
        ok = ok & distinct_first
    value = data if func in ("sum", "avg") else None
    s, cnt = group_agg.grouped_sums_counts_multi(
        [(value, ok)], gid, num_segments)[0]
    if func in ("count_star", "count"):
        return cnt, ones
    has = cnt > 0
    if func == "sum":
        return s, has
    if func == "avg":
        return s.to(torch.float64) / cnt.clamp(min=1).to(torch.float64), has
    if func == "min" or func == "max":
        out = _segment_extreme(data, ok, gid, num_segments, func == "min")
        if data.is_floating_point():
            out = out.to(torch.float64)
        return out, has
    raise ValueError(f"unknown aggregate {func}")


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 plane whose signed order is lax.sort's order of x: for
    floats -inf < ... < 0.0 < ... < inf < NaN, with -0.0 equal to 0.0 and
    every NaN (either sign, any payload) equal to every other, as the
    comparator canonicalizes them; integers and booleans as their values."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    if x.dtype == torch.float64:
        b = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int64)
        b = torch.where(torch.isnan(x), torch.full_like(b, _F64_QNAN), b)
        return b ^ ((b >> 63) & _I64_MAX)
    x = x.to(torch.float32)
    b = torch.where(x == 0, torch.zeros_like(x), x).view(torch.int32)
    b = torch.where(torch.isnan(x), torch.full_like(b, _F32_QNAN), b)
    b = b.to(torch.int64)
    return b ^ ((b >> 31) & _I32_MAX)


def sort_by_group_value(vals: torch.Tensor, ok: torch.Tensor,
                        gid: torch.Tensor, num_groups: int):
    """The rows where `ok` sorted by (group, value), values in lax.sort's
    order (`total_order_key`; equal keys keep their input order), the
    others after them. Returns the sorted group key (num_groups for the
    others), the sorted values, and each group's row count and first
    position (length num_groups), the counts from the sorted keys
    (searchsorted), with no scatter."""
    gkey = torch.where(ok, gid.to(torch.int64),
                       torch.full_like(gid, num_groups, dtype=torch.int64))
    perm = _lexsort([gkey, total_order_key(vals)])
    skey = gkey[perm]
    edges = torch.searchsorted(
        skey, torch.arange(num_groups + 1, device=skey.device))
    start = edges[:-1]
    return skey, vals[perm], edges[1:] - start, start


def group_mode_sorted(skey: torch.Tensor, sval: torch.Tensor,
                      num_groups: int, desc: bool) -> torch.Tensor:
    """MODE() per group over `sort_by_group_value`'s planes: runs of equal
    (group, value) neighbours (compared with !=, so each NaN is a run of
    its own and -0.0 joins 0.0) give run lengths, and a scatter-max of a
    packed (length, position) key picks each group's winner; ties go to
    the FIRST value in the WITHIN GROUP order (PG): the smallest value for
    ASC, the largest for DESC. Empty groups hold an arbitrary value.

    Only run starts carry a key to their group's slot: a run's length is
    the searchsorted end of its number in the (sorted) running count of
    starts, and every other row writes to a slot of its own, so no slot
    takes more atomics than its group has runs."""
    cap = skey.shape[0]
    idx = torch.arange(cap, device=skey.device)
    start = (idx == 0) | (skey != torch.roll(skey, 1)) \
        | (sval != torch.roll(sval, 1))
    run = torch.cumsum(start.to(torch.int64), 0)
    run_len = torch.searchsorted(run, run, right=True) - idx
    big = cap + 1
    tie = idx if desc else cap - idx
    tgt = torch.where(start & (skey < num_groups), skey, num_groups + idx)
    best = torch.full((num_groups + cap,), _I64_MIN, dtype=torch.int64,
                      device=skey.device).scatter_reduce_(
        0, tgt, run_len * big + tie, reduce="amax")[:num_groups]
    pos = (best % big) if desc else (cap - best % big)
    return sval[pos.clamp(0, cap - 1)]


def _segment_extreme(data: torch.Tensor, ok: torch.Tensor, gid: torch.Tensor,
                     num_segments: int, is_min: bool) -> torch.Tensor:
    """Exact segment min/max through the orderable image (one scatter
    reduce; min/max do not depend on order). Results for empty groups are
    the fill value; callers mask by the count plane."""
    y = orderable_i64(data)
    if y.dtype == torch.float64:
        fill = float("inf") if is_min else float("-inf")
    elif y.dtype == torch.int32:
        fill = _I32_MAX if is_min else _I32_MIN
    else:
        fill = _I64_MAX if is_min else _I64_MIN
    src = torch.where(ok, y, torch.full_like(y, fill))
    g = _scatter_drop(num_segments, gid, src, fill, y.dtype,
                      reduce="amin" if is_min else "amax")
    out = from_orderable(g, data.dtype)
    if not data.is_floating_point():
        out = out.to(torch.int64)
    return out


def global_aggregate(
    func: str,
    data: Optional[torch.Tensor],
    validity: Optional[torch.Tensor],
    num_rows,
    out_len: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ungrouped aggregate as a plain reduction. Returns [out_len] planes
    with the result in slot 0 (the layout the executor slices)."""
    ref = data if data is not None else validity
    if ref is None:
        raise ValueError("global_aggregate needs data or validity")
    capacity, device = ref.shape[0], ref.device
    lm = live_mask(capacity, num_rows, device)
    ok = lm if (validity is None or data is None) else (lm & validity)
    cnt = ok.sum(dtype=torch.int64)
    if func in ("count_star", "count"):
        out = torch.zeros(out_len, dtype=torch.int64, device=device)
        out[0] = cnt
        return out, torch.ones(out_len, dtype=torch.bool, device=device)
    has = cnt > 0
    if func in ("sum", "avg"):
        if func == "avg" or data.is_floating_point():
            tot = torch.where(ok, data.to(torch.float64), 0.0).sum()
        else:
            tot = torch.where(ok, data.to(torch.int64), 0).sum()
        if func == "avg":
            tot = tot / cnt.clamp(min=1).to(torch.float64)
    elif func in ("min", "max"):
        if data.is_floating_point():
            fill = float("inf") if func == "min" else float("-inf")
            x = torch.where(ok, data.to(torch.float64), fill)
        else:
            fill = _I64_MAX if func == "min" else _I64_MIN
            x = torch.where(ok, data.to(torch.int64), fill)
        tot = x.min() if func == "min" else x.max()
    else:
        raise ValueError(f"unknown aggregate {func}")
    out = torch.zeros(out_len, dtype=tot.dtype, device=device)
    out[0] = tot
    valid = torch.zeros(out_len, dtype=torch.bool, device=device)
    valid[0] = has
    return out, valid


def distinct_first_flags(
    key_datas: Sequence[torch.Tensor],
    key_valids: Sequence[torch.Tensor],
    gid: torch.Tensor,
    num_rows,
) -> torch.Tensor:
    """True for the first occurrence of each (group, value) pair among the
    live rows: the dedup plane of DISTINCT aggregates. NULL values form one
    value per group. One stable sort on (pad, gid), (null, key) operands:
    pad rows sort last, so a live row is never the repeat of a pad row."""
    capacity = gid.shape[0]
    device = gid.device
    pad = ~live_mask(capacity, num_rows, device)
    # gid < 2^40: the pad flag rides above it in one operand
    operands: List[torch.Tensor] = [(pad.to(torch.int64) << 40)
                                    | gid.to(torch.int64)]
    for data, valid in zip(key_datas, key_valids):
        key, null = normalize_key(data, valid)
        if key.dtype == torch.int32:
            operands.append((null.to(torch.int64) << 32) | _u32_image(key))
        else:
            operands.append(null.to(torch.int32))
            operands.append(key)
    sperm = _lexsort(operands)
    idx = torch.arange(capacity, device=device)
    change = idx == 0
    # equality over (gid, null, key): the pad flag only orders
    for k in [gid.to(torch.int64)] + operands[1:]:
        k = k[sperm]
        change = change | ((idx > 0) & (k != torch.roll(k, 1)))
    first = torch.zeros(capacity, dtype=torch.bool, device=device)
    first[sperm] = change
    return first


# ---------------------------------------------------------------------------
# joins (sort-merge, exact; two-pass count-then-emit)
# ---------------------------------------------------------------------------


def join_ranks(
    left_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    right_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    n_left,
    n_right,
    null_equal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint dense ranks: rank equality <=> key-tuple equality.

    By default rows with any NULL key get unique negative ranks so NULL never
    matches NULL (SQL equi-join). With null_equal=True, NULLs compare equal.
    left_keys/right_keys: per-key (data, validity); capacities may differ.
    Returns (left_ranks[cap_l], right_ranks[cap_r]) int64.
    """
    out = _join_ranks_full(left_keys, right_keys, n_left, n_right,
                           null_equal)
    return out[0], out[1]


def _any_null(left_keys, right_keys) -> torch.Tensor:
    """Per row of the left ++ right concatenation: some key is NULL."""
    any_null = None
    for (_, lv), (_, rv) in zip(left_keys, right_keys):
        n = ~torch.cat([lv, rv])
        any_null = n if any_null is None else any_null | n
    return any_null


def _join_ranks_full(left_keys, right_keys, n_left, n_right,
                     null_equal: bool = False, space=None):
    """Also returns (sorted perm, sorted null-or-pad flag, change flags) of
    the joint sort. `space` = (sperm, sorted_lead, change) of an earlier
    joint sort of the SAME inputs (the count program's, handed to the emit
    program) skips the sort: the ranks come from its segment ids."""
    if space is not None:
        cap_l = left_keys[0][0].shape[0]
        sperm, sorted_lead, change = space
        ranks = torch.zeros_like(sperm)
        ranks[sperm] = _run_ids(change) - 1
        if not null_equal:
            ranks = torch.where(_any_null(left_keys, right_keys),
                                -(torch.arange(sperm.shape[0],
                                               device=sperm.device) + 2),
                                ranks)
        return ranks[:cap_l], ranks[cap_l:], sperm, sorted_lead, change
    sperm, sorted_lead, change, seg = _joint_sort(
        left_keys, right_keys, n_left, n_right, null_equal)
    cap_l = left_keys[0][0].shape[0]
    ranks = torch.zeros_like(sperm)
    ranks[sperm] = seg
    if not null_equal:
        # null keys never match: unique negative rank per row
        ranks = torch.where(
            _any_null(left_keys, right_keys),
            -(torch.arange(sperm.shape[0], device=sperm.device) + 2), ranks)
    return ranks[:cap_l], ranks[cap_l:], sperm, sorted_lead, change


def _joint_sort(left_keys, right_keys, n_left, n_right, null_equal: bool):
    """The stable joint sort of the left ++ right key rows: (sorted perm,
    sorted null-or-pad flag, change flags, segment ids), live non-null rows
    first grouped by key, then NULL-key rows, then pad rows. Within a key
    segment the left rows precede the right rows (stable over the
    concatenation)."""
    device = left_keys[0][0].device
    cap_l = left_keys[0][0].shape[0]
    cap_r = right_keys[0][0].shape[0]
    any_null = _any_null(left_keys, right_keys)
    pad = torch.cat([~live_mask(cap_l, n_left, device),
                     ~live_mask(cap_r, n_right, device)])
    datas: List[torch.Tensor] = []
    valids: List[torch.Tensor] = []
    for (ld, lv), (rd, rv) in zip(left_keys, right_keys):
        a, b = orderable_i64(ld), orderable_i64(rd)
        t = torch.promote_types(a.dtype, b.dtype)  # as jnp.concatenate
        datas.append(torch.cat([a.to(t), b.to(t)]))
        valids.append(torch.cat([lv, rv]))
    # sort order: live non-null rows first (grouped by key), then nulls,
    # then pad — so rank-r rows are contiguous from the front
    lead = pad.to(torch.int32) * 2
    if not null_equal:
        lead = lead + any_null.to(torch.int32)
    lead_thr = 1  # sorted rows with first class >= lead_thr are null/pad
    operands: List[torch.Tensor] = []
    for i, (d, v) in enumerate(zip(datas, valids)):
        dz = torch.where(v, d, torch.zeros_like(d))
        if i == 0:
            cls = lead
            if null_equal:
                cls = lead * 2 + (~v).to(torch.int32)
                lead_thr = 4  # null-in-key0 rows keep real ranks here
        elif null_equal:
            cls = (~v).to(torch.int32)
        else:
            cls = None
        if d.dtype == torch.int32:
            u = _u32_image(dz)
            if cls is not None:
                u = (cls.to(torch.int64) << 32) | u
            operands.append(u)
        else:
            if cls is not None:
                operands.append(cls)
            operands.append(dz)
    sperm = _lexsort(operands)
    sorted_ops = [op[sperm] for op in operands]
    first = sorted_ops[0]
    first_cls = first >> 32 if datas[0].dtype == torch.int32 else first
    sorted_lead = (first_cls >= lead_thr).to(torch.int32)
    change, seg = _segment_ids_from_sorted(sorted_ops, sorted_lead > 0)
    return sperm, sorted_lead, change, seg


def _segment_sides(sperm, sorted_lead, change, cap_l: int):
    """Per sorted position of a joint sort: whether it is a live non-null
    left row and a live non-null right row, the inclusive running counts of
    such left and right rows (L, R), and the first and last position of its
    key segment. Each segment's counts are differences of L and R at its
    ends; no encoded scan is needed."""
    valid = sorted_lead == 0
    is_right = sperm >= cap_l
    left = valid & ~is_right
    right = valid & is_right
    L = torch.cumsum(left.to(torch.int64), 0)
    R = torch.cumsum(right.to(torch.int64), 0)
    return left, right, L, R, _seg_start_pos(change), _seg_end_pos(change)


def join_ranks_counts(
    left_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    right_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    n_left,
    n_right,
    space=None,
):
    """join_ranks + join_counts from ONE joint sort: the per-left-row match
    counts and the right rows' matched flags come from the sorted space
    (each key segment's left and right counts, from the running counts at
    its ends) and are scattered once to row order. `space` is as in
    `_join_ranks_full`.

    Returns (lr, rr, total, counts, offsets, rank_start, right_by_rank,
    left_matched, right_matched): the contract of join_ranks followed by
    join_counts (NULL keys never match)."""
    cap_l = left_keys[0][0].shape[0]
    cap_r = right_keys[0][0].shape[0]
    n_ranks = cap_l + cap_r
    lr, rr, sperm, sorted_lead, change = _join_ranks_full(
        left_keys, right_keys, n_left, n_right, space=space)
    left, right, L, R, start, end = _segment_sides(sperm, sorted_lead,
                                                   change, cap_l)
    # the rights of a segment all follow its lefts: a left row matches
    # every right row of its segment
    n_right_here = R[end] - R[start] + right[start].to(torch.int64)
    counts = _scatter_drop(cap_l, torch.where(left, sperm, -1),
                           torch.where(left, n_right_here, 0), 0, torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    n_left_here = L[end] - L[start] + left[start].to(torch.int64)
    right_matched = _scatter_drop(cap_r, torch.where(right, sperm - cap_l,
                                                     -1),
                                  n_left_here > 0, False, torch.bool)
    # emit machinery: right rows grouped by rank
    r_ok = live_mask(cap_r, n_right, rr.device) & (rr >= 0)
    rr_c = torch.where(r_ok, rr, n_ranks - 1)
    cnt_r = _segment_count(r_ok, rr_c, n_ranks)
    rank_start = torch.cumsum(cnt_r, 0) - cnt_r
    right_by_rank = torch.sort(rr_c, stable=True).indices
    return (lr, rr, total, counts, offsets, rank_start, right_by_rank,
            counts > 0, right_matched)


def join_count_total(
    left_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    right_keys: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    n_left,
    n_right,
    return_space: bool = False,
):
    """The join's size for the count program, from one joint sort and
    reductions over the sorted space (no rank plane, no scatter to row
    order): (total matches, matched left rows, matched right rows) as 0-d
    int64 tensors, plus (sperm, sorted_lead, change) when `return_space`,
    for the emit program to skip its own sort."""
    cap_l = left_keys[0][0].shape[0]
    sperm, sorted_lead, change, _ = _joint_sort(
        left_keys, right_keys, n_left, n_right, null_equal=False)
    left, right, L, R, start, end = _segment_sides(sperm, sorted_lead,
                                                   change, cap_l)
    n_left_here = L[end] - L[start] + left[start].to(torch.int64)
    n_right_here = R[end] - R[start] + right[start].to(torch.int64)
    # each right row meets every left row of its segment
    total = torch.where(right, n_left_here, 0).sum()
    matched_right = (right & (n_left_here > 0)).sum()
    matched_left = (left & (n_right_here > 0)).sum()
    if return_space:
        return total, matched_left, matched_right, (sperm, sorted_lead,
                                                    change)
    return total, matched_left, matched_right


def join_counts(
    left_ranks: torch.Tensor,
    right_ranks: torch.Tensor,
    n_left,
    n_right,
):
    """Pass 1: per-left-row match counts over the dense rank space.

    Returns (total_matches, counts[cap_l], offsets[cap_l] exclusive-cumsum,
    rank_start[n_ranks], right_by_rank[cap_r], left_matched, right_matched).
    rank_start[r] is the start of rank r's rows inside right_by_rank, which
    lists live non-null right row indices grouped by rank.
    """
    device = left_ranks.device
    cap_l = left_ranks.shape[0]
    cap_r = right_ranks.shape[0]
    n_ranks = cap_l + cap_r
    l_ok = live_mask(cap_l, n_left, device) & (left_ranks >= 0)
    r_ok = live_mask(cap_r, n_right, device) & (right_ranks >= 0)
    lr_c = torch.where(l_ok, left_ranks, n_ranks - 1)
    rr_c = torch.where(r_ok, right_ranks, n_ranks - 1)
    cnt_r = _segment_count(r_ok, rr_c, n_ranks)
    cnt_l = _segment_count(l_ok, lr_c, n_ranks)
    # the n_ranks-1 dummy slot may mix pad/null counts; mask at use
    counts = torch.where(l_ok, cnt_r[lr_c], 0)
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    left_matched = counts > 0
    right_matched = r_ok & (cnt_l[rr_c] > 0)
    rank_start = torch.cumsum(cnt_r, 0) - cnt_r  # exclusive cumsum per rank
    # live non-null rows of rank r form a contiguous run of the stable
    # rank sort starting at rank_start[r]
    right_by_rank = torch.sort(rr_c, stable=True).indices
    return (
        total, counts, offsets, rank_start, right_by_rank,
        left_matched, right_matched,
    )


def join_emit_inner(
    counts: torch.Tensor,
    rank_start: torch.Tensor,
    right_by_rank: torch.Tensor,
    left_ranks: torch.Tensor,
    total,
    out_capacity: int,
):
    """Pass 2: emit (left_idx, right_idx) pairs, compacted, left-major.

    out_capacity >= total (the host chose it after pass 1). The owning left
    row of each output slot comes from a scatter of row ids at each row's
    output offset followed by a running max (row-wise, `_cummax`: a 1-D
    torch.cummax on CUDA is one thread block's scan) — no searchsorted.
    The offsets of rows with matches are distinct, so the scatter is a
    plain store, and each row without one stores into a spill slot of its
    own: on the card an atomic max of millions of rows into one shared
    spill slot took 270-300 ms at 2^23 left rows.
    """
    device = counts.device
    cap_l = counts.shape[0]
    starts = torch.cumsum(counts, 0) - counts
    rows = torch.arange(cap_l, device=device)
    mark = _scatter_drop(out_capacity + cap_l,
                         torch.where(counts > 0, starts, out_capacity + rows),
                         rows, 0, torch.int64)[:out_capacity]
    owner = _cummax(mark)
    t = torch.arange(out_capacity, device=device)
    j = t - starts[owner]
    lrank = left_ranks[owner].clamp(0, rank_start.shape[0] - 1)
    rpos = rank_start[lrank] + j
    ri = right_by_rank[rpos.clamp(0, right_by_rank.shape[0] - 1)]
    valid = t < total
    return torch.where(valid, owner, 0), torch.where(valid, ri, 0), valid


def fk_join_right_lookup(
    left_ranks: torch.Tensor,
    right_ranks: torch.Tensor,
    n_left,
    n_right,
    n_ranks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FK fast path for joins whose build (right) side is UNIQUE per key:
    each probe row has at most one match, so the emit is a direct rank ->
    right-row lookup (output rows sit at their left-row positions; callers
    carry a selection mask). Returns (right_row per left row, 0 where
    unmatched; matched mask)."""
    device = left_ranks.device
    cap_l = left_ranks.shape[0]
    cap_r = right_ranks.shape[0]
    if n_ranks is None:
        n_ranks = cap_l + cap_r
    r_ok = live_mask(cap_r, n_right, device) & (right_ranks >= 0)
    rows_r = torch.arange(cap_r, device=device)
    table = _scatter_drop(n_ranks, torch.where(r_ok, right_ranks, n_ranks),
                          rows_r, -1, torch.int64)
    l_ok = live_mask(cap_l, n_left, device) & (left_ranks >= 0)
    ri = torch.where(l_ok, table[left_ranks.clamp(0, n_ranks - 1)], -1)
    matched = ri >= 0
    return torch.where(matched, ri, 0), matched


def rank_member(lr: torch.Tensor, rr: torch.Tensor, r_live: torch.Tensor,
                n_ranks: Optional[int] = None) -> torch.Tensor:
    """member[i] = probe rank lr[i] occurs among the live right ranks (IN
    subquery membership): one presence scatter over the rank space and one
    probe gather. Negative (NULL-key) ranks are never members."""
    cap_l = lr.shape[0]
    cap_r = rr.shape[0]
    if n_ranks is None:
        n_ranks = cap_l + cap_r
    r_ok = r_live & (rr >= 0)
    pres = _scatter_drop(n_ranks, torch.where(r_ok, rr, n_ranks), True,
                         False, torch.bool)
    return (lr >= 0) & pres[lr.clamp(0, n_ranks - 1)]


def unmatched_indices(matched: torch.Tensor, num_rows, out_capacity: int):
    """Rows with no match (for outer joins): compacted indices + count."""
    um = ~matched & live_mask(matched.shape[0], num_rows, matched.device)
    count = um.sum(dtype=torch.int64)
    idx = compaction_indices(um, num_rows, out_capacity)
    return idx, count


# ---------------------------------------------------------------------------
# segment positions over sorted rows
# ---------------------------------------------------------------------------


# torch.cummax/cummin of a 1-D CUDA tensor is one thread block's scan, so
# positions come from a prefix count, a scatter and a gather instead, and
# value scans from row scans (`_cummax`)


def _run_ids(flags: torch.Tensor) -> torch.Tensor:
    """Per row, the number of flagged rows at or before it: its run's
    number from 1 (0 before the first flag)."""
    return torch.cumsum(flags.to(torch.int64), 0)


def _seg_start_pos(seg_change: torch.Tensor) -> torch.Tensor:
    """Index of the first row of each row's segment (0 before the first
    flag)."""
    capacity = seg_change.shape[0]
    idx = torch.arange(capacity, device=seg_change.device)
    run = _run_ids(seg_change)
    starts = _scatter_drop(capacity + 1, torch.where(seg_change, run, -1),
                           idx, 0, torch.int64)
    return starts[run]


def _seg_end_pos(seg_change: torch.Tensor) -> torch.Tensor:
    """Index of the last row of each row's segment."""
    capacity = seg_change.shape[0]
    idx = torch.arange(capacity, device=seg_change.device)
    # no host scalar stored into a device tensor: a CUDA graph captures this
    nxt = torch.roll(seg_change, -1) | (idx == capacity - 1)
    run = _run_ids(seg_change)
    ends = _scatter_drop(capacity + 1, torch.where(nxt, run, -1), idx, 0,
                         torch.int64)
    return ends[run]


def _block_scan(x: torch.Tensor, scan, combine, pad, row: int
                ) -> torch.Tensor:
    """Inclusive scan of a 1-D plane in a fixed order: each row of x viewed
    as [-1, row] is scanned by itself (torch's per-row scan, `scan(X)` over
    dim 1), then the rows' last elements are scanned the same way,
    recursively, and combined into the rows after them. `pad` is the
    scan's neutral element."""
    n = x.shape[0]
    if n <= row:  # two rows: torch scans a 2-D tensor row by row
        return scan(torch.stack([x, torch.full_like(x, pad)]))[0]
    nb = -(-n // row)
    xp = torch.cat([x, x.new_full((nb * row - n,), pad)]) \
        if nb * row != n else x
    within = scan(xp.view(nb, row))
    tops = _block_scan(within[:, -1].contiguous(), scan, combine, pad, row)
    before = torch.cat([tops.new_full((1,), pad), tops[:-1]])
    return combine(within, before[:, None]).reshape(-1)[:n]


def _cummax(x: torch.Tensor, row: int = 1024) -> torch.Tensor:
    """Running maximum of a 1-D integer plane."""
    return _block_scan(x, lambda X: torch.cummax(X, 1).values, torch.maximum,
                       torch.iinfo(x.dtype).min, row)


# ---------------------------------------------------------------------------
# CROSS joins
# ---------------------------------------------------------------------------


def cross_join_indices(n_left: int, n_right: int, out_capacity: int,
                       device="cpu"):
    """CROSS join index planes, left-major (the reference's take-based
    repetition, executor.rs:437-498): (left idx, right idx, valid)."""
    t = torch.arange(out_capacity, device=device)
    total = n_left * n_right
    li = t // max(n_right, 1)
    ri = t % max(n_right, 1)
    valid = t < total
    return torch.where(valid, li, 0), torch.where(valid, ri, 0), valid


# ---------------------------------------------------------------------------
# window functions (over rows already in window order; the caller sorts and
# scatters the results back through the inverse permutation)
#
# Frame descriptors: ("partition",) | ("range_current",) | ("rows", s, e)
# with s/e = None for UNBOUNDED and an int row offset (0 = CURRENT ROW) |
# ("range_off", s, e): value distances over the single ORDER BY key.
# ---------------------------------------------------------------------------


def window_segments(part_sorted: Sequence[torch.Tensor],
                    order_sorted: Sequence[torch.Tensor],
                    pad_sorted: torch.Tensor):
    """Over key planes already in window order: the segment (partition)
    start flags, the peer (order key change) start flags and the segment
    id of each row. Pad rows form one trailing segment."""
    capacity = pad_sorted.shape[0]
    idx = torch.arange(capacity, device=pad_sorted.device)
    seg_change = idx == 0
    for k in part_sorted:
        seg_change = seg_change | ((idx > 0) & (k != torch.roll(k, 1)))
    seg_change = seg_change | (pad_sorted & ~torch.roll(pad_sorted, 1))
    peer_change = seg_change
    for k in order_sorted:
        peer_change = peer_change | ((idx > 0) & (k != torch.roll(k, 1)))
    seg = torch.cumsum(seg_change.to(torch.int64), 0) - 1
    return seg_change, peer_change, seg


def row_number_sorted(seg_change: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(seg_change.shape[0], device=seg_change.device)
    return idx - _seg_start_pos(seg_change) + 1


def rank_sorted(seg_change: torch.Tensor, peer_change: torch.Tensor
                ) -> torch.Tensor:
    return _seg_start_pos(peer_change) - _seg_start_pos(seg_change) + 1


def dense_rank_sorted(seg_change: torch.Tensor, peer_change: torch.Tensor
                      ) -> torch.Tensor:
    peers = _run_ids(peer_change)
    # peers only grow: its value at the segment's first row (0 before it)
    at_seg_start = torch.where(_run_ids(seg_change) > 0,
                               peers[_seg_start_pos(seg_change)], 0)
    return peers - at_seg_start + 1


def ntile_sorted(seg_change: torch.Tensor, n_tiles: int,
                 pad_sorted: torch.Tensor) -> torch.Tensor:
    """PG NTILE: q = count // n, r = count % n; the first r buckets get
    q + 1 rows. `n_tiles` is a host int (a literal of the query)."""
    rn = row_number_sorted(seg_change) - 1  # 0-based
    count = _seg_end_pos(seg_change) - _seg_start_pos(seg_change) + 1
    count = torch.where(pad_sorted, 1, count)
    n = max(int(n_tiles), 1)
    q = count // n
    r = count % n
    big = r * (q + 1)
    bucket = torch.where(
        rn < big,
        rn // (q + 1).clamp(min=1),
        r + torch.where(q > 0, (rn - big) // q.clamp(min=1), 0),
    )
    return bucket + 1


def percent_rank_sorted(seg_change: torch.Tensor, peer_change: torch.Tensor
                        ) -> torch.Tensor:
    """PG PERCENT_RANK = (rank - 1) / (count - 1); 0 for 1-row partitions."""
    rank = rank_sorted(seg_change, peer_change)
    count = (_seg_end_pos(seg_change) - _seg_start_pos(seg_change)
             + 1).to(torch.float64)
    return torch.where(
        count > 1,
        (rank - 1).to(torch.float64) / (count - 1.0).clamp(min=1.0),
        0.0,
    )


def cume_dist_sorted(seg_change: torch.Tensor, peer_change: torch.Tensor
                     ) -> torch.Tensor:
    """PG CUME_DIST = (rows <= the current one, tie peers included) /
    count: the last tie peer's position gives the numerator (a peer run
    never crosses a segment boundary)."""
    start = _seg_start_pos(seg_change)
    count = (_seg_end_pos(seg_change) - start + 1).to(torch.float64)
    peers_thru = (_seg_end_pos(peer_change) - start + 1).to(torch.float64)
    return peers_thru / count.clamp(min=1.0)


def _row_scan(x: torch.Tensor, row: int = 4096) -> torch.Tensor:
    """Inclusive prefix sum in a fixed order (`_block_scan`)."""
    return _block_scan(x, lambda X: torch.cumsum(X, 1), torch.add, 0, row)


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D plane with the same bits on every run.
    torch.cumsum of a 1-D float CUDA tensor is one device-wide scan whose
    partial sums combine in an order set by when blocks finish, so float
    planes take _row_scan; integers (exact in any order) take
    torch.cumsum."""
    return _row_scan(x) if x.is_floating_point() else torch.cumsum(x, 0)


def _extreme_plane(vals: torch.Tensor, ok: torch.Tensor, is_min: bool):
    """(values widened to float64 or int64 with non-ok rows set to the
    neutral element, the neutral element)."""
    if vals.is_floating_point():
        neutral = float("inf") if is_min else float("-inf")
        x = vals.to(torch.float64)
    else:
        neutral = _I64_MAX if is_min else _I64_MIN
        x = vals.to(torch.int64)
    return torch.where(ok, x, torch.full_like(x, neutral)), neutral


def _running_extreme(x: torch.Tensor, ok: torch.Tensor, seg: torch.Tensor,
                     is_min: bool, neutral, key=None) -> torch.Tensor:
    """Running min/max of the ok rows of x within segments (`seg`
    nondecreasing ids); rows with no ok row yet in their segment get
    `neutral`. The values go to their positions in one stable sort by
    `key` (x itself when None), and ONE int64 cummax runs over
    (segment id << 34) | (nan << 33) | (ok << 32) | position: segment ids
    only grow along the plane, so the maximum resets at each boundary and
    any ok row beats the rows before it that are not; MIN takes the
    complemented position. The position maps back to its value. When x
    orders itself, a NaN holds from its row to its segment's end, as
    minimum/maximum pass NaN on; a `key` (float32's orderable image) ranks
    a NaN where its image lies."""
    cap = x.shape[0]
    dev = x.device
    order = torch.sort(x if key is None else key, stable=True).indices
    sv = x[order]
    pos = torch.empty_like(order)
    pos[order] = torch.arange(cap, device=dev)
    if is_min:
        pos = (cap - 1) - pos
    flags = ok.to(torch.int64) << 32
    if key is None and x.is_floating_point():
        flags = flags | ((ok & torch.isnan(x)).to(torch.int64) << 33)
    enc = (seg.to(torch.int64) << 34) | torch.where(ok, flags | pos, 0)
    m = _cummax(enc)
    seen = ((m >> 32) & 1) != 0
    p = m & 0xFFFFFFFF
    if is_min:
        p = (cap - 1) - p
    got = sv[p.clamp(0, cap - 1)]
    return torch.where(seen, got, torch.full_like(got, neutral))


def _segment_running_extreme(vals: torch.Tensor, ok: torch.Tensor,
                             seg_change: torch.Tensor, is_min: bool
                             ) -> torch.Tensor:
    """Running MIN/MAX within segments, float64 for float values and int64
    otherwise; the neutral element (+-inf, INT64_MAX/MIN) before a
    segment's first ok row. float32 values rank by their orderable image
    (NaN above +inf, or below -inf when its sign is set; -0 below +0);
    wider floats pass NaN on."""
    x, neutral = _extreme_plane(vals, ok, is_min)
    seg = torch.cumsum(seg_change.to(torch.int64), 0) - 1
    key = _f32_orderable_bits(vals) if vals.dtype == torch.float32 else None
    return _running_extreme(x, ok, seg, is_min, neutral, key)


def _segment_running_extreme_rev(x: torch.Tensor, ok: torch.Tensor,
                                 seg_change: torch.Tensor, is_min: bool,
                                 neutral) -> torch.Tensor:
    """The reverse running extreme: over [row, its segment's end]."""
    seg = torch.cumsum(seg_change.to(torch.int64), 0) - 1
    seg_f = seg[-1] - torch.flip(seg, (0,))  # nondecreasing again
    out = _running_extreme(torch.flip(x, (0,)), torch.flip(ok, (0,)), seg_f,
                           is_min, neutral)
    return torch.flip(out, (0,))


def range_off_order_plane(kd: torch.Tensor, kok: torch.Tensor, asc: bool,
                          nulls_first: bool):
    """Normalize a sorted ORDER BY key plane for a value-distance frame:
    DESC negates (offsets then apply uniformly as [k - s, k + e]); NULL
    keys get a sentinel at the end of the segment they occupy in window
    order, so the joint sort reproduces window-order positions exactly.
    Shared by the eager executor and the compiled pipeline."""
    if not asc:
        kd = -kd
    if kd.is_floating_point():
        s_lo, s_hi = float("-inf"), float("inf")
    else:
        info = torch.iinfo(kd.dtype)
        s_lo, s_hi = info.min // 2, info.max // 2
    sent = s_lo if nulls_first else s_hi
    return torch.where(kok, kd, torch.full_like(kd, sent)), kok


def _range_off_bounds(okey, okey_ok, seg_change, peer_change, pad_sorted,
                      s_off, e_off):
    """Per-row [lo, hi] POSITIONS for a value-distance frame (RANGE BETWEEN
    s_off PRECEDING AND e_off FOLLOWING) over rows in window order. `okey`
    is the single ORDER BY key in sorted order, nondecreasing within each
    segment (DESC pre-negated). The bounds `okey - s_off` and
    `okey + e_off` are computed in the key's own dtype.

    One joint stable sort of (segment, key, tag) over the data rows and one
    probe per bounded side (tag 0 sorts before equal data keys, tag 2
    after): the count of data rows before a probe's slot is its boundary
    position. Rows with a NULL order key frame their NULL peer group (PG).
    """
    cap = okey.shape[0]
    dev = okey.device
    idx = torch.arange(cap, device=dev)
    seg = torch.cumsum(seg_change.to(torch.int64), 0) - 1
    seg = torch.where(pad_sorted, cap, seg)
    segs, keys, tags, ids = [seg], [okey], [torch.ones_like(seg)], [idx]
    if s_off is not None:
        segs.append(seg)
        keys.append(okey - s_off)
        tags.append(torch.zeros_like(seg))  # before equal keys
        ids.append(idx)
    if e_off is not None:
        segs.append(seg)
        keys.append(okey + e_off)
        tags.append(torch.full_like(seg, 2))  # after equal keys
        ids.append(idx)
    tag = torch.cat(tags)
    sperm = _lexsort([torch.cat(segs), torch.cat(keys), tag])
    stag = tag[sperm]
    sid = torch.cat(ids)[sperm]
    is_data = (stag == 1).to(torch.int64)
    data_before = torch.cumsum(is_data, 0) - is_data
    seg_start = _seg_start_pos(seg_change)
    seg_end = _seg_end_pos(seg_change)
    if s_off is not None:
        lo = _scatter_drop(cap, torch.where(stag == 0, sid, -1), data_before,
                           0, torch.int64)
        lo = torch.maximum(lo, seg_start)
    else:
        lo = seg_start
    if e_off is not None:
        hi = _scatter_drop(cap, torch.where(stag == 2, sid, -1), data_before,
                           0, torch.int64) - 1
        hi = torch.minimum(hi, seg_end)
    else:
        hi = seg_end
    # NULL order keys: the frame is the row's NULL peer group
    lo = torch.where(okey_ok, lo, _seg_start_pos(peer_change))
    hi = torch.where(okey_ok, hi, _seg_end_pos(peer_change))
    return lo, hi


def window_frame_bounds(frame, seg_change, peer_change, pad_sorted,
                        order_plane=None):
    """Per-row frame [lo, hi] POSITIONS in window order for any frame
    descriptor; shared by the aggregate windows and the positional value
    functions (FIRST_VALUE / LAST_VALUE / NTH_VALUE read lo / hi /
    lo + n - 1). An empty frame has hi < lo."""
    idx = torch.arange(seg_change.shape[0], device=seg_change.device)
    seg_start = _seg_start_pos(seg_change)
    seg_end = _seg_end_pos(seg_change)
    kind = frame[0]
    if kind == "partition":
        return seg_start, seg_end
    if kind == "range_current":
        return seg_start, _seg_end_pos(peer_change)
    if kind == "range_off":
        okey, okey_ok = order_plane
        return _range_off_bounds(okey, okey_ok, seg_change, peer_change,
                                 pad_sorted, frame[1], frame[2])
    _, s_off, e_off = frame
    lo = seg_start if s_off is None else torch.maximum(idx - s_off, seg_start)
    hi = seg_end if e_off is None else torch.minimum(idx + e_off, seg_end)
    return lo, hi


def window_aggregate_sorted(
    func: str,
    vals: Optional[torch.Tensor],
    ok: Optional[torch.Tensor],
    seg_change: torch.Tensor,
    peer_change: torch.Tensor,
    pad_sorted: torch.Tensor,
    frame,
    order_plane=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """COUNT(*)/COUNT/SUM/AVG/MIN/MAX over a frame, for rows in window
    order. Returns (values, valid) in window order.

    func: count_star | count | sum | avg | min | max; vals/ok: the argument
    in window order (None for count_star); frame: a frame descriptor;
    order_plane: ("range_off" only) (key, key valid) in window order, DESC
    pre-negated (range_off_order_plane).

    COUNT and SUM are prefix differences, P[hi] - P[lo - 1] of one prefix
    sum over the plane (two gathers; `_prefix_sum`, the same bits on every
    run). MIN/MAX: a per-segment reduce for the
    whole partition, a running extreme read at the frame's end for an
    unbounded start (at its start for an unbounded end), and the van
    Herk/Gil-Werman block decomposition for bounded ROWS frames.
    """
    cap = seg_change.shape[0]
    dev = seg_change.device
    idx = torch.arange(cap, device=dev)
    live = ~pad_sorted
    ok_live = live if (ok is None or vals is None) else (ok & live)
    kind = frame[0]
    lo, hi = window_frame_bounds(frame, seg_change, peer_change, pad_sorted,
                                 order_plane)
    empty = hi < lo
    lo_c = lo.clamp(0, cap - 1)
    hi_c = hi.clamp(0, cap - 1)
    lo_prev = (lo - 1).clamp(0, cap - 1)

    def frame_range(P):
        before = torch.where(lo > 0, P[lo_prev], torch.zeros_like(P))
        return P[hi_c] - before

    cnt = torch.where(
        empty, 0, frame_range(torch.cumsum(ok_live.to(torch.int64), 0)))
    if func in ("count", "count_star"):
        return cnt, torch.ones(cap, dtype=torch.bool, device=dev)
    if vals is None:
        raise ValueError(f"window aggregate {func} needs a value plane")
    if func in ("sum", "avg"):
        acc = torch.float64 if vals.is_floating_point() else torch.int64
        x = torch.where(ok_live, vals.to(acc), torch.zeros((), dtype=acc,
                                                           device=dev))
        ssum = torch.where(empty, torch.zeros((), dtype=acc, device=dev),
                           frame_range(_prefix_sum(x)))
        if func == "avg":
            return (ssum.to(torch.float64)
                    / cnt.clamp(min=1).to(torch.float64), cnt > 0)
        return ssum, cnt > 0
    if func not in ("min", "max"):
        raise ValueError(f"unknown window aggregate {func}")
    is_min = func == "min"
    whole = kind == "partition" or (
        kind == "rows" and frame[1] is None and frame[2] is None)
    if whole:
        seg = torch.cumsum(seg_change.to(torch.int64), 0) - 1
        per_seg = _segment_extreme(vals, ok_live, seg, cap, is_min)
        return per_seg[seg], cnt > 0
    if kind == "range_current" or frame[1] is None:
        # unbounded start: the running extreme, read at the frame's end
        run = _segment_running_extreme(vals, ok_live, seg_change, is_min)
        return run[hi_c], cnt > 0
    x, neutral = _extreme_plane(vals, ok_live, is_min)
    if kind == "range_off":
        if frame[2] is None:
            # unbounded end: the reverse running extreme, read at the start
            rev = _segment_running_extreme_rev(x, ok_live, seg_change,
                                               is_min, neutral)
            return rev[lo_c], cnt > 0
        raise ExecutionError(
            "MIN/MAX over a bounded RANGE offset frame is not supported")
    # bounded ROWS start: van Herk / Gil-Werman block decomposition for the
    # interior windows; the running and reverse running extremes cover the
    # frames clamped at a segment edge
    s_off, e_off = frame[1], frame[2]
    run = _segment_running_extreme(vals, ok_live, seg_change, is_min)
    rev = _segment_running_extreme_rev(x, ok_live, seg_change, is_min,
                                       neutral)
    if e_off is None:  # frame = [max(i - s, seg_start), seg_end]
        return rev[lo_c], cnt > 0
    pick = torch.minimum if is_min else torch.maximum
    red = torch.cummin if is_min else torch.cummax
    k = s_off + e_off + 1
    nb = -(-cap // k)
    xp = torch.cat([x, torch.full((nb * k - cap,), neutral, dtype=x.dtype,
                                  device=dev)])
    X = xp.reshape(nb, k)
    pref = red(X, 1).values.reshape(-1)
    suff = torch.flip(red(torch.flip(X, (1,)), 1).values, (1,)).reshape(-1)
    # the window of size k ending at j: pick(suff[j - k + 1], pref[j]);
    # both read only positions inside [j - k + 1, j], so an interior window
    # never reads across a segment boundary
    start_pos = (hi_c - k + 1).clamp(0, cap - 1)
    vh = pick(suff[start_pos], pref[hi_c])
    start_clamped = (idx - s_off) < lo
    end_clamped = (idx + e_off) > hi
    out = torch.where(start_clamped, run[hi_c],
                      torch.where(end_clamped, rev[lo_c], vh))
    return out, cnt > 0


def shift_in_segment(values: torch.Tensor, valid: torch.Tensor,
                     seg: torch.Tensor, offset: int):
    """LAG (offset > 0) / LEAD (offset < 0) within segments: a constant
    shift (torch.roll); a source outside the segment gives NULL."""
    capacity = values.shape[0]
    idx = torch.arange(capacity, device=values.device)
    src = idx - offset
    in_range = (src >= 0) & (src < capacity)
    same_seg = in_range & (torch.roll(seg, offset) == seg)
    out = torch.where(same_seg, torch.roll(values, offset),
                      torch.zeros_like(values))
    return out, same_seg & torch.roll(valid, offset)


def value_at(values: torch.Tensor, valid: torch.Tensor, pos: torch.Tensor):
    pos_c = pos.clamp(0, values.shape[0] - 1)
    return values[pos_c], valid[pos_c]
