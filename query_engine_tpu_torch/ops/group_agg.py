"""Grouped SUM/COUNT: the hand-written CUDA kernel and its plain version.

Counterpart of `query_engine_tpu/ops/pallas/group_agg.py`, with the same
entry points and results:

  * `grouped_sums_counts_multi(items, gid, num_groups)` — `items` is a list
    of (values, ok) with integer or float dtypes, `gid` the dense group id
    per row (a row whose id is outside [0, num_groups) is excluded). Returns
    one (sums[G], counts[G]) per item: integer sums exact int64 (mod 2^64),
    float sums float64 with IEEE semantics per group (inf + finite = inf,
    inf + -inf or any NaN = NaN), counts int64.
  * `grouped_sum_count(values, ok, gid, num_groups)` — one column.

Which version runs is decided by the device of the tensors, nothing else:

  * on a CUDA tensor the kernel in `csrc/group_agg.cu` runs (built at first
    use by ops/_build.py), or the call raises. Integer columns go in as they
    are; a float column is quantized on the device to dynamic-scale fixed
    point, q = round(x * 2^k) with k from max|x| (the JAX kernel's scheme,
    group_agg.py:243-290 there), summed exactly as int64, and rescaled; its
    +inf, -inf and NaN rows are counted by three extra columns of the same
    launch. Error bound ~ n * max|x| * 2^-40, like float64 summation
    round-off; the bits are the same on every run;
  * on a CPU tensor the plain version runs: an int64 `index_add_` for
    integers and a float64 `index_add_` for floats — what the JAX package
    computes on its CPU path (kernels.py:757-760 there).

`launches` counts the kernel's launches in this process.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch

launches = 0

Items = Sequence[Tuple[torch.Tensor, torch.Tensor]]
Accumulate = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, int],
    Tuple[torch.Tensor, torch.Tensor],
]


# ---------------------------------------------------------------------------
# the int64 accumulators: gid [n] int32, vals [C, n] int64, ok [C, n] bool
#   -> sums [C, G] int64, counts [C, G] int64
# ---------------------------------------------------------------------------


def accumulate_plain(gid: torch.Tensor, vals: torch.Tensor, ok: torch.Tensor,
                     num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's contract in torch ops (any device): int64 index_add_,
    exact and order-independent."""
    g = gid.to(torch.int64)
    ok = ok & ((g >= 0) & (g < num_groups))
    g = torch.where(ok, g, torch.zeros_like(g))  # [C, n] by broadcast
    n_cols = vals.shape[0]
    flat = (torch.arange(n_cols, device=g.device)[:, None] * num_groups + g)
    flat = flat.reshape(-1)
    size = n_cols * num_groups
    sums = torch.zeros(size, dtype=torch.int64, device=g.device)
    counts = torch.zeros(size, dtype=torch.int64, device=g.device)
    sums.index_add_(0, flat, torch.where(ok, vals, 0).reshape(-1))
    counts.index_add_(0, flat, ok.to(torch.int64).reshape(-1))
    return sums.view(n_cols, num_groups), counts.view(n_cols, num_groups)


def accumulate_kernel(gid: torch.Tensor, vals: torch.Tensor, ok: torch.Tensor,
                      num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `qe_group_sum_count_i64` on the current CUDA stream."""
    global launches
    from query_engine_tpu_torch.ops._build import load_library

    if gid.device.type != "cuda":
        raise ValueError(f"the group_agg kernel needs CUDA tensors, got "
                         f"{gid.device}")
    if vals.dim() != 2 or ok.shape != vals.shape or gid.dim() != 1 \
            or vals.shape[1] != gid.shape[0]:
        raise ValueError(f"shapes: gid {tuple(gid.shape)}, vals "
                         f"{tuple(vals.shape)}, ok {tuple(ok.shape)}")
    if (gid.dtype, vals.dtype, ok.dtype) != (torch.int32, torch.int64,
                                             torch.bool):
        raise ValueError(f"dtypes: gid {gid.dtype} (int32), vals "
                         f"{vals.dtype} (int64), ok {ok.dtype} (bool)")
    if not (vals.device == ok.device == gid.device):
        raise ValueError("gid, vals and ok must be on one device")
    if not (gid.is_contiguous() and vals.is_contiguous()
            and ok.is_contiguous()):
        raise ValueError("gid, vals and ok must be contiguous")
    if not 0 < num_groups < 2**31:
        raise ValueError(f"num_groups {num_groups} out of range")
    n_cols, n = vals.shape
    sums = torch.zeros((n_cols, num_groups), dtype=torch.int64,
                       device=gid.device)
    counts = torch.zeros_like(sums)
    if n == 0 or n_cols == 0:
        return sums, counts
    lib = load_library().lib
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        rc = lib.qe_group_sum_count_i64(
            gid.data_ptr(), vals.data_ptr(), ok.data_ptr(), n, n_cols,
            num_groups, sums.data_ptr(), counts.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"qe_group_sum_count_i64 failed: cudaError {rc}")
    launches += 1
    return sums, counts


# ---------------------------------------------------------------------------
# fixed point for float columns
# ---------------------------------------------------------------------------


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact float64 2^k for int k in [-1022, 1023], from the bits."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def quantize(values: torch.Tensor, ok: torch.Tensor):
    """(q int64 with 0 where not (ok and finite), 2^-k float64 0-d tensor).
    k is chosen on the device from max|x| so that n * max|q| < 2^62."""
    n = values.shape[0]
    x = values.to(torch.float64)
    finite = torch.isfinite(x)
    xf = torch.where(ok & finite, x, 0.0)
    m = xf.abs().max() if n else torch.zeros((), dtype=torch.float64,
                                             device=x.device)
    frac_bits = min(61 - max(math.ceil(math.log2(max(n, 2))), 1), 40)
    # m = mant * 2^e with mant in [0.5, 1): e = floor(log2 m) + 1
    _, e = torch.frexp(m.clamp(min=torch.finfo(torch.float64).tiny))
    k = (frac_bits - e.to(torch.int64)).clamp(-1000, 1000)
    q = torch.round(xf * _pow2(k)).to(torch.int64)
    return q, _pow2(-k)


def finish_float(sums_q: torch.Tensor, n_pos: torch.Tensor,
                 n_neg: torch.Tensor, n_nan: torch.Tensor,
                 inv_scale: torch.Tensor) -> torch.Tensor:
    """Rescale fixed-point sums and apply IEEE semantics per group."""
    s = sums_q.to(torch.float64) * inv_scale
    p, ng, nn = n_pos > 0, n_neg > 0, n_nan > 0
    s = torch.where(p & ~ng, float("inf"), s)
    s = torch.where(ng & ~p, float("-inf"), s)
    return torch.where(nn | (p & ng), float("nan"), s)


def fixed_point_multi(items: Items, gid: torch.Tensor, num_groups: int,
                      accumulate: Accumulate) -> List[tuple]:
    """All items through ONE accumulate call: an integer item is one int64
    column; a float item is four — its fixed-point values and its +inf,
    -inf and NaN row counts."""
    gid32 = gid.to(torch.int32).contiguous()
    vals: List[torch.Tensor] = []
    oks: List[torch.Tensor] = []
    layout = []  # (first column, inverse scale or None) per item
    for v, ok in items:
        layout.append((len(vals), None))
        if v.is_floating_point():
            q, inv = quantize(v, ok)
            x = v.to(torch.float64)
            layout[-1] = (len(vals), inv)
            # flag columns only read their counts; q rides as their values
            vals += [q, q, q, q]
            oks += [ok, ok & torch.isposinf(x), ok & torch.isneginf(x),
                    ok & torch.isnan(x)]
        else:
            vals.append(v.to(torch.int64))
            oks.append(ok)
    sums, counts = accumulate(gid32, torch.stack(vals), torch.stack(oks),
                              num_groups)
    out = []
    for c, inv in layout:
        if inv is None:
            out.append((sums[c], counts[c]))
        else:
            out.append((finish_float(sums[c], counts[c + 1], counts[c + 2],
                                     counts[c + 3], inv), counts[c]))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def grouped_sums_counts_multi_plain(items: Items, gid: torch.Tensor,
                                    num_groups: int) -> List[tuple]:
    """The plain version (any device): int64 index_add_ for integer items,
    float64 index_add_ for float items."""
    g = gid.to(torch.int64)
    in_range = (g >= 0) & (g < num_groups)
    g = torch.where(in_range, g, torch.zeros_like(g))
    out = []
    for v, ok in items:
        m = ok & in_range
        dt = torch.float64 if v.is_floating_point() else torch.int64
        s = torch.zeros(num_groups, dtype=dt, device=g.device)
        s.index_add_(0, g, torch.where(m, v.to(dt), torch.zeros((), dtype=dt,
                                                                device=g.device)))
        c = torch.zeros(num_groups, dtype=torch.int64, device=g.device)
        c.index_add_(0, g, m.to(torch.int64))
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
        if v.device != dev or ok.device != dev:
            raise ValueError("items and gid must be on one device")
        if v.shape != gid.shape or ok.shape != gid.shape:
            raise ValueError("items and gid must have one length")
    if dev.type == "cpu":
        return grouped_sums_counts_multi_plain(items, gid, num_groups)
    if dev.type != "cuda":
        raise ValueError(f"no group_agg implementation for device {dev}")
    return fixed_point_multi(items, gid, num_groups, accumulate_kernel)


def grouped_sum_count(values: torch.Tensor, ok: torch.Tensor,
                      gid: torch.Tensor, num_groups: int) -> tuple:
    """One column: (sums, counts); sums int64 for integers, float64 for
    floats. Rows where `ok` is False are excluded."""
    gid_m = torch.where(ok, gid.to(torch.int32), -1)
    return grouped_sums_counts_multi([(values, ok)], gid_m, num_groups)[0]
