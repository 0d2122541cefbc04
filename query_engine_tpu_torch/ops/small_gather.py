"""Small-table gather of packed words: the hand-written CUDA kernel and its
plain version.

Counterpart of `query_engine_tpu/ops/pallas/small_gather.py`, with the same
contract as its `mxu_gather_words`:

  * `gather_words(idx, table_words)` — `idx` [n] int32 row indices,
    `table_words` [T, W] 32-bit words (T <= MAX_TABLE in the engine).
    Returns [n, W] words: row i is `table_words[idx[i]]`, and all zeros when
    `idx[i]` lies outside [0, T) (the -1 of an unmatched row, pad rows).

Words are carried as int32 bit patterns (torch has no usable uint32): a word
w >= 2^31 is stored as w - 2^32. Callers that hold words as int64 values in
[0, 2^32) convert with `to_bits` and `from_bits`.

Which version runs is decided by the device of the tensors, nothing else:
on a CUDA tensor the kernel in `csrc/small_gather.cu` runs (built at first
use by ops/_build.py), or the call raises; on a CPU tensor the plain version
runs.

`launches` counts the kernel's launches in this process.
"""

from __future__ import annotations

import torch

MAX_TABLE = 4096  # the engine's gate on the build side (kernels.py)

launches = 0


def to_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def from_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2^32)."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def gather_words_plain(idx: torch.Tensor, table_words: torch.Tensor
                       ) -> torch.Tensor:
    """The plain version (any device): one clamped row gather, zeroed where
    the index is out of range."""
    t = table_words.shape[0]
    if t == 0:
        return torch.zeros((idx.shape[0], table_words.shape[1]),
                           dtype=table_words.dtype, device=idx.device)
    ok = (idx >= 0) & (idx < t)
    rows = table_words[idx.clamp(0, t - 1)]
    return torch.where(ok[:, None], rows, 0)


def gather_words_kernel(idx: torch.Tensor, table_words: torch.Tensor
                        ) -> torch.Tensor:
    """Launch `qe_small_gather_u32` on the current CUDA stream."""
    global launches
    from query_engine_tpu_torch.ops._build import load_library

    if idx.device.type != "cuda" or table_words.device != idx.device:
        raise ValueError(f"the small gather kernel needs idx and table on one "
                         f"CUDA device, got {idx.device} and "
                         f"{table_words.device}")
    if idx.dim() != 1 or table_words.dim() != 2:
        raise ValueError(f"shapes: idx {tuple(idx.shape)} (n,), table "
                         f"{tuple(table_words.shape)} (T, W)")
    if (idx.dtype, table_words.dtype) != (torch.int32, torch.int32):
        raise ValueError(f"dtypes: idx {idx.dtype}, table {table_words.dtype}"
                         " (both int32)")
    if not (idx.is_contiguous() and table_words.is_contiguous()):
        raise ValueError("idx and table must be contiguous")
    n = idx.shape[0]
    t, w = table_words.shape
    if t >= 2**31 or n * max(w, 1) >= 2**62:
        raise ValueError(f"table of {t} rows or {n} x {w} output out of range")
    out = torch.empty((n, w), dtype=torch.int32, device=idx.device)
    if n == 0 or w == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = lib.qe_small_gather_u32(idx.data_ptr(), table_words.data_ptr(),
                                     n, t, w, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"qe_small_gather_u32 failed: cudaError {rc}")
    launches += 1
    return out


def gather_words(idx: torch.Tensor, table_words: torch.Tensor
                 ) -> torch.Tensor:
    """table_words[idx] with zeros for out-of-range indices (see the module
    docstring). Both tensors must be on one device."""
    if idx.device != table_words.device:
        raise ValueError("idx and table_words must be on one device")
    if idx.dtype != torch.int32 or table_words.dtype != torch.int32:
        raise ValueError(f"dtypes: idx {idx.dtype}, table {table_words.dtype}"
                         " (both int32)")
    if idx.device.type == "cpu":
        return gather_words_plain(idx, table_words)
    if idx.device.type != "cuda":
        raise ValueError(f"no small gather implementation for device "
                         f"{idx.device}")
    return gather_words_kernel(idx.contiguous(), table_words.contiguous())
