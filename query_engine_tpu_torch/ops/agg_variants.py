"""Grouped SUM/COUNT as one-hot tensor-core products: the hand-written
CUDA kernels of the aggregate probes and their plain versions.

Counterpart of the Pallas kernels in `benchmarks/probe_agg_variants.py`
(v1, v2, v4, v5) and `benchmarks/probe_int8_mxu.py` (s8). All five compute
one thing: per group, the sum (exact mod 2^64) of `where(ok, values, 0)` and
the count of included rows, as totals of small integer chunks of each row's
64-bit value that are recombined outside the kernel:

  * "v1": 8 byte lanes, a count lane and 3 flag lanes (L = 12; the flag
    plane is all zero for integers, as the JAX probe passes it);
  * "v2", "v4", "v5": 8 byte lanes and a count lane (L = 9);
  * "s8": 16 nibble lanes and a count lane (L = 17).

A row is included when `ok` is set and 0 <= gid < num_groups (1024 for
v1-v5, at most 1024 for s8).

The steps:

  * `prepare(values, ok, gid)` -> (vlo, vhi, gid_m): the low and high 32-bit
    words of `where(ok, values, 0)` as int32 bit patterns, and `where(ok,
    gid, -1)`;
  * `chunk_totals(variant, vlo, vhi, gid_m, num_groups)` -> int64 [G, L]:
    on a CUDA tensor the variant's kernel (csrc/agg_onehot_bytes.cu,
    agg_onehot_factorized.cu, agg_onehot_s8.cu, built at first use by
    ops/_build.py) runs, or the call raises; on a CPU tensor the plain
    version runs (`index_add_` over the chunk planes, any device);
  * `recombine(variant, tot)` -> (sums, counts): sum_k tot[:, k] << (w * k)
    in int64, which wraps mod 2^64 as the JAX probes' uint64 shifts do.

`launches[variant]` counts each kernel's launches in this process.
"""

from __future__ import annotations

from typing import Tuple

import torch

VARIANTS = ("v1", "v2", "v4", "v5", "s8")
NUM_GROUPS = 1024  # v1-v5 aggregate exactly 1024 groups; s8 at most 1024
LANES = {"v1": 12, "v2": 9, "v4": 9, "v5": 9, "s8": 17}
CHUNK_BITS = {"v1": 8, "v2": 8, "v4": 8, "v5": 8, "s8": 4}

launches = {v: 0 for v in VARIANTS}


def prepare(values: torch.Tensor, ok: torch.Tensor, gid: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vlo, vhi, gid_m), each int32 [n] and contiguous."""
    u = torch.where(ok, values.to(torch.int64), 0)
    vlo = u.to(torch.int32)  # the low word: a cast to int32 wraps
    vhi = (u >> 32).to(torch.int32)
    gid_m = torch.where(ok, gid.to(torch.int32), -1)
    return vlo.contiguous(), vhi.contiguous(), gid_m.contiguous()


def _check_groups(variant: str, num_groups: int) -> None:
    if variant not in LANES:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    if variant == "s8":
        if not 0 < num_groups <= NUM_GROUPS:
            raise ValueError(f"s8 takes 1..{NUM_GROUPS} groups, got "
                             f"{num_groups}")
    elif num_groups != NUM_GROUPS:
        raise ValueError(f"{variant} aggregates exactly {NUM_GROUPS} groups, "
                         f"got {num_groups}")


def chunk_planes(variant: str, vlo: torch.Tensor, vhi: torch.Tensor
                 ) -> torch.Tensor:
    """[n, L] int64: each row's chunk lanes, the count lane (1) and, for v1,
    the zero flag lanes."""
    bits = CHUNK_BITS[variant]
    per_word = 32 // bits
    shifts = torch.arange(per_word, device=vlo.device, dtype=torch.int32)
    shifts = shifts * bits
    mask = (1 << bits) - 1
    lo = (vlo[:, None] >> shifts) & mask  # arithmetic shift, then masked
    hi = (vhi[:, None] >> shifts) & mask
    n = vlo.shape[0]
    extra = torch.zeros((n, LANES[variant] - 2 * per_word), dtype=torch.int32,
                        device=vlo.device)
    extra[:, 0] = 1  # the count lane
    return torch.cat([lo, hi, extra], dim=1).to(torch.int64)


def chunk_totals_plain(variant: str, vlo: torch.Tensor, vhi: torch.Tensor,
                       gid_m: torch.Tensor, num_groups: int = NUM_GROUPS
                       ) -> torch.Tensor:
    """The plain version (any device): one int64 `index_add_` of the chunk
    planes into [G + 1, L], row G collecting the excluded rows."""
    _check_groups(variant, num_groups)
    g = gid_m.to(torch.int64)
    g = torch.where((g >= 0) & (g < num_groups), g, num_groups)
    tot = torch.zeros((num_groups + 1, LANES[variant]), dtype=torch.int64,
                      device=gid_m.device)
    tot.index_add_(0, g, chunk_planes(variant, vlo, vhi))
    return tot[:num_groups]


def chunk_totals_kernel(variant: str, vlo: torch.Tensor, vhi: torch.Tensor,
                        gid_m: torch.Tensor, num_groups: int = NUM_GROUPS
                        ) -> torch.Tensor:
    """Launch the variant's kernel on the current CUDA stream."""
    from query_engine_tpu_torch.ops._build import load_library

    _check_groups(variant, num_groups)
    planes = (gid_m, vlo, vhi)
    if any(t.device.type != "cuda" or t.device != gid_m.device
           for t in planes):
        raise ValueError(f"the {variant} kernel needs gid_m, vlo and vhi on "
                         f"one CUDA device, got "
                         f"{[str(t.device) for t in planes]}")
    if any(t.dtype != torch.int32 for t in planes):
        raise ValueError(f"dtypes: {[t.dtype for t in planes]} (all int32)")
    n = gid_m.shape[0]
    if any(t.dim() != 1 or t.shape[0] != n for t in planes):
        raise ValueError(f"shapes: {[tuple(t.shape) for t in planes]} (all "
                         "[n])")
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("gid_m, vlo and vhi must be contiguous")
    if any(t.data_ptr() % 16 for t in planes):  # the kernels' vector loads
        raise ValueError("gid_m, vlo and vhi must start 16-byte aligned")
    tot = torch.zeros((num_groups, LANES[variant]), dtype=torch.int64,
                      device=gid_m.device)
    if n == 0:
        return tot
    lib = load_library().lib
    with torch.cuda.device(gid_m.device):
        stream = torch.cuda.current_stream(gid_m.device).cuda_stream
        ptrs = (gid_m.data_ptr(), vlo.data_ptr(), vhi.data_ptr())
        if variant in ("v1", "v2"):
            # v1 reads a flag plane, all zero for integers (the JAX probe's)
            flags = torch.zeros_like(vlo) if variant == "v1" else None
            rc = lib.qe_onehot_bytes(
                *ptrs, None if flags is None else flags.data_ptr(), n,
                tot.data_ptr(), stream)
            name = "qe_onehot_bytes"
        elif variant in ("v4", "v5"):
            rc = lib.qe_onehot_factorized(*ptrs, n, int(variant == "v4"),
                                          tot.data_ptr(), stream)
            name = "qe_onehot_factorized"
        else:
            rc = lib.qe_onehot_s8(*ptrs, n, num_groups, tot.data_ptr(),
                                  stream)
            name = "qe_onehot_s8"
    if rc != 0:
        raise RuntimeError(f"{name} ({variant}) failed: cudaError {rc}")
    launches[variant] += 1
    return tot


def chunk_totals(variant: str, vlo: torch.Tensor, vhi: torch.Tensor,
                 gid_m: torch.Tensor, num_groups: int = NUM_GROUPS
                 ) -> torch.Tensor:
    """int64 [G, L] chunk totals; the device of the tensors picks the
    version (see the module docstring)."""
    dev = gid_m.device
    if vlo.device != dev or vhi.device != dev:
        raise ValueError("gid_m, vlo and vhi must be on one device")
    if dev.type == "cpu":
        return chunk_totals_plain(variant, vlo, vhi, gid_m, num_groups)
    if dev.type != "cuda":
        raise ValueError(f"no {variant} aggregate for device {dev}")
    return chunk_totals_kernel(variant, vlo, vhi, gid_m, num_groups)


def recombine(variant: str, tot: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, L] chunk totals -> (sums int64 [G], counts int64 [G]). The
    int64 shifts and sum wrap mod 2^64."""
    bits = CHUNK_BITS[variant]
    k = 64 // bits
    shifts = torch.arange(k, device=tot.device, dtype=torch.int64) * bits
    sums = (tot[:, :k] << shifts).sum(dim=1)
    return sums, tot[:, k].clone()


def grouped_sum_count(variant: str, values: torch.Tensor, ok: torch.Tensor,
                      gid: torch.Tensor, num_groups: int = NUM_GROUPS
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, counts), int64 [num_groups], through the variant's chunk
    totals."""
    if not (values.shape == ok.shape == gid.shape) or values.dim() != 1:
        raise ValueError(f"values {tuple(values.shape)}, ok "
                         f"{tuple(ok.shape)} and gid {tuple(gid.shape)} must "
                         "be one [n]")
    vlo, vhi, gid_m = prepare(values, ok, gid)
    return recombine(variant, chunk_totals(variant, vlo, vhi, gid_m,
                                           num_groups))
