"""Small-table gather of packed words: the hand-written CUDA kernel and its
plain versions.

Counterpart of `query_engine_tpu/ops/pallas/small_gather.py`. One kernel
(`csrc/small_gather.cu`) behind two entry points:

  * `gather_words(idx, table_words)` — the contract of the JAX package's
    `mxu_gather_words`: `idx` [n] int32 row indices, `table_words` [T, W]
    32-bit words as int32 bit patterns (T <= MAX_TABLE in the engine).
    Returns [n, W] int32: row i is `table_words[idx[i]]`, and all zeros
    when `idx[i]` lies outside [0, T) (the -1 of an unmatched row, pad
    rows).
  * `gather_word_planes(idx, planes)` — the join's form: `idx` [n] int64
    (the index plane as the pipeline holds it), `planes` [W, T] int64 words
    in [0, 2^32) (the packed planes, stacked). Returns [W, n] int64: plane
    w, row i is `planes[w, idx[i]]`, zero where `idx[i]` lies outside
    [0, T). Only a value's low 32 bits are gathered.

Torch has no usable uint32: in the first form a word w >= 2^31 is stored
as w - 2^32 (`to_bits`, `from_bits` convert); the second form takes and
gives the int64 planes, so the join needs no conversion pass.

Which version runs is decided by the device of the tensors, nothing else:
on a CUDA tensor the kernel runs (built at first use by ops/_build.py), or
the call raises; on a CPU tensor the plain version runs.

`launches` counts the kernel's launches in this process, through either
entry point.
"""

from __future__ import annotations

import torch

MAX_TABLE = 4096  # the engine's gate on the build side (kernels.py)
MAX_WORDS = 32  # the JAX kernel's limit: 4 byte lanes a word, 128 lanes

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


def gather_word_planes_plain(idx: torch.Tensor, planes: torch.Tensor
                             ) -> torch.Tensor:
    """The plain version of `gather_word_planes` (any device)."""
    t = planes.shape[1]
    if t == 0:
        return torch.zeros((planes.shape[0], idx.shape[0]),
                           dtype=torch.int64, device=idx.device)
    ok = (idx >= 0) & (idx < t)
    rows = planes[:, idx.clamp(0, t - 1)] & 0xFFFFFFFF
    return torch.where(ok, rows, 0)


def _launch(entry: str, idx: torch.Tensor, table: torch.Tensor, t: int,
            w: int, out: torch.Tensor) -> torch.Tensor:
    """Checks what every launch needs, then launches `entry` on the current
    CUDA stream; raises if the launch failed."""
    global launches
    from query_engine_tpu_torch.ops._build import load_library

    if not (idx.is_contiguous() and table.is_contiguous()):
        raise ValueError("idx and the table must be contiguous")
    n = idx.shape[0]
    if t >= 2**31 or not 1 <= w <= MAX_WORDS or n >= 2**62 // max(w, 1):
        raise ValueError(f"a table of {t} rows and {w} words (at most "
                         f"{MAX_WORDS}), or {n} rows, out of range")
    if idx.data_ptr() % idx.element_size():
        raise ValueError("idx is not aligned to its element")
    if n == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = getattr(lib, entry)(idx.data_ptr(), table.data_ptr(), n, t, w,
                                 out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    launches += 1
    return out


def _check_devices(name: str, idx: torch.Tensor, table: torch.Tensor):
    if idx.device.type != "cuda" or table.device != idx.device:
        raise ValueError(f"the small gather kernel needs idx and {name} on "
                         f"one CUDA device, got {idx.device} and "
                         f"{table.device}")


def gather_words_kernel(idx: torch.Tensor, table_words: torch.Tensor
                        ) -> torch.Tensor:
    """Launch `qe_small_gather_u32` on the current CUDA stream."""
    _check_devices("table", idx, table_words)
    if idx.dim() != 1 or table_words.dim() != 2:
        raise ValueError(f"shapes: idx {tuple(idx.shape)} (n,), table "
                         f"{tuple(table_words.shape)} (T, W)")
    if (idx.dtype, table_words.dtype) != (torch.int32, torch.int32):
        raise ValueError(f"dtypes: idx {idx.dtype}, table {table_words.dtype}"
                         " (both int32)")
    t, w = table_words.shape
    out = torch.empty((idx.shape[0], w), dtype=torch.int32,
                      device=idx.device)
    if w == 0:
        return out
    return _launch("qe_small_gather_u32", idx, table_words, t, w, out)


def gather_word_planes_kernel(idx: torch.Tensor, planes: torch.Tensor
                              ) -> torch.Tensor:
    """Launch `qe_small_gather_planes` on the current CUDA stream. `idx`
    may be a view at any element offset: the kernel takes the rows before
    its first 16-byte boundary one at a time, with no copy."""
    _check_devices("planes", idx, planes)
    if idx.dim() != 1 or planes.dim() != 2:
        raise ValueError(f"shapes: idx {tuple(idx.shape)} (n,), planes "
                         f"{tuple(planes.shape)} (W, T)")
    if (idx.dtype, planes.dtype) != (torch.int64, torch.int64):
        raise ValueError(f"dtypes: idx {idx.dtype}, planes {planes.dtype}"
                         " (both int64)")
    w, t = planes.shape
    out = torch.empty((w, idx.shape[0]), dtype=torch.int64,
                      device=idx.device)
    if w == 0:
        return out
    return _launch("qe_small_gather_planes", idx, planes, t, w, out)


def _dispatch(idx, table, dtype, plain, kernel):
    if idx.device != table.device:
        raise ValueError("idx and the table must be on one device")
    if idx.dtype != dtype or table.dtype != dtype:
        raise ValueError(f"dtypes: idx {idx.dtype}, table {table.dtype} "
                         f"(both {dtype})")
    if idx.device.type == "cpu":
        return plain(idx, table)
    if idx.device.type != "cuda":
        raise ValueError(f"no small gather implementation for device "
                         f"{idx.device}")
    return kernel(idx, table)


def gather_words(idx: torch.Tensor, table_words: torch.Tensor
                 ) -> torch.Tensor:
    """table_words[idx] with zeros for out-of-range indices (see the module
    docstring). Both tensors int32, on one device."""
    return _dispatch(idx, table_words, torch.int32, gather_words_plain,
                     lambda i, t: gather_words_kernel(i.contiguous(),
                                                      t.contiguous()))


def gather_word_planes(idx: torch.Tensor, planes: torch.Tensor
                       ) -> torch.Tensor:
    """planes[:, idx] & 0xFFFFFFFF with zeros for out-of-range indices (see
    the module docstring). Both tensors int64, on one device."""
    return _dispatch(idx, planes, torch.int64, gather_word_planes_plain,
                     gather_word_planes_kernel)
