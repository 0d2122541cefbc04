"""Grouped SUM/COUNT: the hand-written CUDA kernel and its plain versions.

Counterpart of `query_engine_tpu/ops/pallas/group_agg.py`, with the same
entry points and results:

  * `grouped_sums_counts_multi(items, gid, num_groups)` — `items` is a list
    of (values, ok) with integer or float dtypes, or (None, ok) for a COUNT
    that reads only its ok plane (a column of ones: its sum is its count);
    `gid` the dense group id per row (int32 or int64; a row whose id is
    outside [0, num_groups) is excluded). Returns one (sums[G], counts[G])
    per item: integer sums exact int64 (mod 2^64), float sums float64 with
    IEEE semantics per group (inf + finite = inf, inf + -inf or any NaN =
    NaN), counts int64.
  * `grouped_sum_count(values, ok, gid, num_groups)` — one column.

Which version runs is decided by the device of the tensors, nothing else:

  * on a CUDA tensor the kernel in `csrc/group_agg.cu` runs (built at first
    use by ops/_build.py), or the call raises. One launch reads every item
    where it lies. A float item is dynamic-scale fixed point, q = round(x *
    2^k) with k = 62 - e where max|x| < 2^e (so |q| < 2^62 at any n), its
    sum kept exactly in two int64 rows (the low and the high 32 bits of
    each q, summed apart) and rebuilt with one float64 rounding
    (`finish_float`); its +inf, -inf and NaN rows set flag bits. A group of
    m rows is within m * max|x| * 2^-62 of the exact sum of its values,
    plus that rounding, whatever the plane's capacity; the bits are the
    same on every run. The JAX kernel (group_agg.py:243-290 there) sums
    one word with n * 2^frac_bits < 2^61, whose quantum grows with n;
  * on a CPU tensor `grouped_sums_counts_multi_plain` runs: an int64
    `index_add_` for integers and a float64 `index_add_` for floats — what
    the JAX package computes on its CPU path (kernels.py:757-760 there).

`accumulate_plain` is the kernel's contract in torch ops (descriptors in,
the same [R, G] rows and scales out, bit for bit); `fixed_point(items, gid,
G, accumulate_plain)` is the card's route run on any device.

`launches` counts the kernel's launches in this process (from any
thread: the virtual mesh's shards launch from threads of their own).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

launches = 0
_launches_lock = threading.Lock()

Items = Sequence[Tuple[Optional[torch.Tensor], torch.Tensor]]

# item kinds of the kernel's descriptors (csrc/group_agg.cu) and the output
# rows of each: COUNT -> count; I64/I32 -> sum, count; F64/F32 -> sum_lo,
# sum_hi, count, flags (1 = +inf, 2 = -inf, 4 = NaN)
COUNT, I64, I32, F64, F32 = range(5)
ROWS = {COUNT: 1, I64: 2, I32: 2, F64: 4, F32: 4}
# a float item's fixed point: |q| < 2^Q_BITS, q split at bit HALF
Q_BITS = 62
HALF = 32
LOW = (1 << HALF) - 1
MAX_ITEMS = 16  # descriptors per launch


def _kind(values: Optional[torch.Tensor]) -> int:
    if values is None:
        return COUNT
    if values.is_floating_point():
        return F32 if values.dtype == torch.float32 else F64
    return I64 if values.dtype == torch.int64 else I32


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address, as the kernel's 16-byte
    loads need (a fresh allocation is; a view with an offset is copied)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _as_kind(values: Optional[torch.Tensor], kind: int):
    """The values as the kernel reads them: int64, int32, float64 or
    float32; narrower types widen exactly."""
    if values is None:
        return None
    dtype = {I64: torch.int64, I32: torch.int32, F64: torch.float64,
             F32: torch.float32}[kind]
    return _aligned(values.to(dtype))


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float64 2^k for int k in [-1022, 1023], from the bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def quantize(values: torch.Tensor, ok: torch.Tensor):
    """(q int64 with 0 where not (ok and finite), 2^-k float64 0-d tensor).
    k = Q_BITS - e is chosen on the device from max|x| < 2^e, so |q| <
    2^Q_BITS whatever the number of rows."""
    n = values.shape[0]
    x = values.to(torch.float64)
    finite = torch.isfinite(x)
    xf = torch.where(ok & finite, x, 0.0)
    m = xf.abs().max() if n else torch.zeros((), dtype=torch.float64,
                                             device=x.device)
    # m = mant * 2^e with mant in [0.5, 1): e = floor(log2 m) + 1
    _, e = torch.frexp(m.clamp(min=torch.finfo(torch.float64).tiny))
    k = (Q_BITS - e.to(torch.int64)).clamp(-1000, 1000)
    q = torch.round(xf * _pow2(k)).to(torch.int64)
    return q, _pow2(-k)


def two_words(values: torch.Tensor, ok: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float plane as two float64 items whose fixed-point sums lose
    nothing of it: hi = x rounded to a grid two bits coarser than the one
    `quantize` gives x (so the kernel's own grid for hi, at most one bit
    coarser than x's, holds hi exactly and its sums are exact), and lo =
    x - hi (exact: hi and x are within a factor 2, or hi is 0), whose
    quantum is 2^-Q_BITS of hi's. Summing both items and adding the two
    sums gives a group's float sum to float64 rounding. +-inf and NaN rows
    stay in hi (lo 0), so the flags apply."""
    x = values.to(torch.float64)
    fin = ok & torch.isfinite(x)
    _, inv = quantize(x, ok)
    step = inv * 4
    hi = torch.where(fin, torch.round(x / step) * step, x)
    return hi, torch.where(fin, x - hi, 0.0)


def two_word_sums(values: torch.Tensor, ok: torch.Tensor, gid: torch.Tensor,
                  num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float plane's grouped (sums, counts), the sum as two fixed-point
    words (`two_words`) in one call: the combine of a few partials a
    group."""
    hi, lo = two_words(values, ok)
    (s_hi, cnt), (s_lo, _) = grouped_sums_counts_multi(
        [(hi, ok), (lo, ok)], gid, num_groups)
    return s_hi + s_lo, cnt


def exact_to_float(sum_lo: torch.Tensor, sum_hi: torch.Tensor
                   ) -> torch.Tensor:
    """float64 of sum_hi * 2^HALF + sum_lo, correctly rounded (one
    rounding). sum_lo >= 0; carry its high bits into sum_hi first, then
    split sum_hi into its float64 value and the rest, which with the low
    bits is exact in float64, and add the two."""
    hi = sum_hi + (sum_lo >> HALF)
    lo = sum_lo & LOW
    hf = hi.to(torch.float64)  # |hi| < 2^62: the cast back is exact
    rest = ((hi - hf.to(torch.int64)) << HALF) + lo  # |rest| < 2^41
    return hf * float(1 << HALF) + rest.to(torch.float64)


def finish_float(sum_lo: torch.Tensor, sum_hi: torch.Tensor,
                 flags: torch.Tensor, inv_scale: torch.Tensor
                 ) -> torch.Tensor:
    """Rescale exact fixed-point sums (`exact_to_float`) and apply IEEE
    semantics per group from the flag bits (1: some +inf, 2: some -inf, 4:
    some NaN): inf + finite = inf, inf + -inf or any NaN = NaN."""
    s = exact_to_float(sum_lo, sum_hi) * inv_scale
    # the value of each flag combination; fill_ keeps it capturable
    ieee = torch.full((8,), float("nan"), dtype=torch.float64,
                      device=s.device)
    ieee[1:2].fill_(float("inf"))
    ieee[2:3].fill_(float("-inf"))
    return torch.where(flags == 0, s, ieee[flags])


# ---------------------------------------------------------------------------
# the accumulators: items, gid [n], G -> rows [R, G] int64, inv_scale [F]
# ---------------------------------------------------------------------------

Accumulate = Callable[[Items, torch.Tensor, int],
                      Tuple[torch.Tensor, torch.Tensor]]


def accumulate_plain(items: Items, gid: torch.Tensor, num_groups: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in torch ops (any device): int64 index_add_,
    exact and order-independent, so bit for bit the kernel's output."""
    dev = gid.device
    g = gid.to(torch.int64)
    in_range = (g >= 0) & (g < num_groups)
    g = torch.where(in_range, g, torch.zeros_like(g))

    def add(src: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(num_groups, dtype=torch.int64, device=dev)
        return out.index_add_(0, g, src.to(torch.int64))

    rows, scales = [], []
    for v, ok in items:
        m = ok & in_range
        kind = _kind(v)
        if kind == COUNT:
            rows.append(add(m))
        elif kind in (I64, I32):
            rows += [add(torch.where(m, v.to(torch.int64), 0)), add(m)]
        else:
            q, inv = quantize(v, ok)
            x = v.to(torch.float64)
            flags = sum((add(m & cls) > 0).to(torch.int64) << bit
                        for bit, cls in enumerate((torch.isposinf(x),
                                                   torch.isneginf(x),
                                                   torch.isnan(x))))
            rows += [add(torch.where(m, q & LOW, 0)),
                     add(torch.where(m, q >> HALF, 0)), add(m), flags]
            scales.append(inv)
    inv_scale = (torch.stack(scales) if scales
                 else torch.zeros(0, dtype=torch.float64, device=dev))
    return torch.stack(rows), inv_scale


def accumulate_kernel(items: Items, gid: torch.Tensor, num_groups: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `qe_group_agg` on the current CUDA stream, one launch per
    MAX_ITEMS items; reads gid and every item where it lies."""
    global launches
    from query_engine_tpu_torch.ops._build import load_library

    if gid.device.type != "cuda":
        raise ValueError(f"the group_agg kernel needs CUDA tensors, got "
                         f"{gid.device}")
    if gid.dtype not in (torch.int32, torch.int64) or gid.dim() != 1:
        raise ValueError(f"gid must be an int32 or int64 vector, got "
                         f"{gid.dtype} {tuple(gid.shape)}")
    gid = _aligned(gid)
    n = gid.shape[0]
    if not 0 < num_groups < 2**31 or n >= 2**31:
        raise ValueError(f"num_groups {num_groups} or n {n} out of range")
    kinds = [_kind(v) for v, _ in items]
    planes = []
    for (v, ok), kind in zip(items, kinds):
        if ok.dtype != torch.bool or ok.shape != gid.shape \
                or ok.device != gid.device \
                or (v is not None and (v.shape != gid.shape
                                       or v.device != gid.device)):
            raise ValueError("each item: values and a bool ok plane of "
                             "gid's length on gid's device")
        planes.append((_as_kind(v, kind), _aligned(ok)))
    n_rows = sum(ROWS[k] for k in kinds)
    n_float = sum(k in (F64, F32) for k in kinds)
    out = torch.empty((n_rows, num_groups), dtype=torch.int64,
                      device=gid.device)
    fmax = torch.empty(n_float, dtype=torch.int64, device=gid.device)
    inv_scale = torch.empty(n_float, dtype=torch.float64, device=gid.device)
    lib = load_library().lib
    row = fl = 0
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for c in range(0, len(items), MAX_ITEMS):
            ks = kinds[c:c + MAX_ITEMS]
            pl = planes[c:c + MAX_ITEMS]
            k = len(ks)
            rc = lib.qe_group_agg(
                gid.data_ptr(), int(gid.dtype == torch.int64), n, num_groups,
                k, (ctypes.c_int * k)(*ks),
                (ctypes.c_void_p * k)(*[None if v is None else v.data_ptr()
                                        for v, _ in pl]),
                (ctypes.c_void_p * k)(*[ok.data_ptr() for _, ok in pl]),
                out[row].data_ptr(),
                fmax[fl:].data_ptr() if fl < n_float else None,
                inv_scale[fl:].data_ptr() if fl < n_float else None,
                stream,
            )
            if rc != 0:
                raise RuntimeError(f"qe_group_agg failed: cudaError {rc}")
            with _launches_lock:
                launches += 1
            row += sum(ROWS[x] for x in ks)
            fl += sum(x in (F64, F32) for x in ks)
    return out, inv_scale


def fixed_point(items: Items, gid: torch.Tensor, num_groups: int,
                accumulate: Accumulate) -> List[tuple]:
    """The card's route: one accumulate call for every item, then each
    item's (sums, counts) from its rows of the output."""
    rows, inv_scale = accumulate(items, gid, num_groups)
    out = []
    r = f = 0
    for v, _ in items:
        kind = _kind(v)
        if kind == COUNT:
            out.append((rows[r], rows[r]))
        elif kind in (I64, I32):
            out.append((rows[r], rows[r + 1]))
        else:
            out.append((finish_float(rows[r], rows[r + 1], rows[r + 3],
                                     inv_scale[f]), rows[r + 2]))
            f += 1
        r += ROWS[kind]
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def on_card(t: torch.Tensor) -> bool:
    """The route of a tensor: the kernel for a CUDA tensor, the plain
    version for a CPU tensor. (The CPU tests emulate the card's route by
    patching this and `accumulate_kernel`.)"""
    return t.device.type == "cuda"


def grouped_sums_counts_multi_plain(items: Items, gid: torch.Tensor,
                                    num_groups: int) -> List[tuple]:
    """The CPU route and the JAX-parity reference (any device): int64
    index_add_ for integer items, float64 index_add_ for float items."""
    g = gid.to(torch.int64)
    in_range = (g >= 0) & (g < num_groups)
    g = torch.where(in_range, g, torch.zeros_like(g))
    out = []
    for v, ok in items:
        m = ok & in_range
        c = torch.zeros(num_groups, dtype=torch.int64, device=g.device)
        c.index_add_(0, g, m.to(torch.int64))
        if v is None:
            out.append((c, c))
            continue
        dt = torch.float64 if v.is_floating_point() else torch.int64
        s = torch.zeros(num_groups, dtype=dt, device=g.device)
        s.index_add_(0, g, torch.where(m, v.to(dt), torch.zeros((), dtype=dt,
                                                                device=g.device)))
        out.append((s, c))
    return out


def grouped_sums_counts_multi(items: Items, gid: torch.Tensor,
                              num_groups: int) -> List[tuple]:
    """Batched grouped SUM/COUNT (see the module docstring). One kernel
    launch covers every item."""
    if not items:
        return []
    dev = gid.device
    for v, ok in items:
        if ok.device != dev or (v is not None and v.device != dev):
            raise ValueError("items and gid must be on one device")
        if ok.shape != gid.shape or (v is not None and v.shape != gid.shape):
            raise ValueError("items and gid must have one length")
    if not on_card(gid):
        if dev.type != "cpu":
            raise ValueError(f"no group_agg implementation for device {dev}")
        return grouped_sums_counts_multi_plain(items, gid, num_groups)
    if gid.dtype not in (torch.int32, torch.int64):
        gid = gid.to(torch.int32)
    return fixed_point(items, gid, num_groups, accumulate_kernel)


def grouped_sum_count(values: torch.Tensor, ok: torch.Tensor,
                      gid: torch.Tensor, num_groups: int) -> tuple:
    """One column: (sums, counts); sums int64 for integers, float64 for
    floats. Rows where `ok` is False are excluded."""
    return grouped_sums_counts_multi([(values, ok)], gid, num_groups)[0]
