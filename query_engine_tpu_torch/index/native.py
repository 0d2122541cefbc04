"""ctypes bindings for the native C++ index structures (native/qe_native.cpp).

The shared library is compiled on demand with g++ and cached next to the
source; if no toolchain is available the pure-Python implementations in
btree.py / hash.py are used instead (same API, same semantics).

Key encoding mirrors the reference IndexKey (query-index/src/types.rs:82-116):
an order-preserving byte string per scalar — type tag byte, then big-endian
u64 with the sign bit flipped for ints, the IEEE sign-flip trick for floats
(so int/float share a numeric order via widening to f64), raw utf8 for
strings. memcmp order == value order.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
from typing import List, Sequence

import numpy as np

from query_engine_tpu_torch.core.errors import IndexError_
from query_engine_tpu_torch.index.types import Index

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "qe_native.cpp")
_LIB = os.path.join(_REPO_ROOT, "native", "libqe_native.so")

_lib = None
_lib_lock = threading.Lock()


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SRC):
            return None
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            try:
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     _SRC, "-o", _LIB],
                    check=True, capture_output=True, timeout=120,
                )
            except (subprocess.SubprocessError, FileNotFoundError):
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        u64 = ctypes.c_uint64
        p64 = ctypes.POINTER(ctypes.c_uint64)
        for prefix in ("btree", "hash"):
            getattr(lib, f"qe_{prefix}_new").restype = ctypes.c_void_p
            getattr(lib, f"qe_{prefix}_new").argtypes = [ctypes.c_int]
            getattr(lib, f"qe_{prefix}_free").argtypes = [ctypes.c_void_p]
            getattr(lib, f"qe_{prefix}_insert").argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, u64, u64]
            getattr(lib, f"qe_{prefix}_bulk_insert").restype = ctypes.c_int64
            getattr(lib, f"qe_{prefix}_bulk_insert").argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, p64, p64, u64]
            getattr(lib, f"qe_{prefix}_delete").argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, u64, u64]
            getattr(lib, f"qe_{prefix}_lookup").restype = u64
            getattr(lib, f"qe_{prefix}_lookup").argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, u64, p64, u64]
            getattr(lib, f"qe_{prefix}_len").restype = u64
            getattr(lib, f"qe_{prefix}_len").argtypes = [ctypes.c_void_p]
            getattr(lib, f"qe_{prefix}_clear").argtypes = [ctypes.c_void_p]
        lib.qe_btree_range.restype = u64
        lib.qe_btree_range.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, u64, ctypes.c_int,
            ctypes.c_char_p, u64, ctypes.c_int, p64, u64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


_UNBOUNDED = ctypes.c_uint64(0xFFFFFFFFFFFFFFFF).value


def encode_scalar_bytes(v) -> bytes:
    """Order-preserving byte encoding of one scalar (IndexKey parity)."""
    if v is None:
        return b"\x00"
    if isinstance(v, bool):
        v = float(v)
    if isinstance(v, (int, float, np.integer, np.floating)):
        # widen to f64 so ints and floats share one numeric order, then the
        # sign-flip trick: flip all bits for negatives, flip sign bit for
        # positives -> unsigned big-endian memcmp order == numeric order
        bits = struct.unpack(">Q", struct.pack(">d", float(v)))[0]
        if bits & (1 << 63):
            bits ^= 0xFFFFFFFFFFFFFFFF
        else:
            bits ^= 1 << 63
        return b"\x01" + struct.pack(">Q", bits)
    return b"\x02" + str(v).encode("utf-8")


def encode_key_bytes(values: Sequence) -> bytes:
    # length-prefix each part so composite keys can't alias across parts
    out = bytearray()
    for v in values:
        part = encode_scalar_bytes(v)
        out += struct.pack(">I", len(part)) + part
    return bytes(out)


# numeric planes whose Python values (Column.to_pylist) are int, float or
# bool: encoded straight from the plane
_NUMERIC_KINDS = frozenset(
    ("Boolean", "Int8", "Int16", "Int32", "Int64", "UInt8", "UInt16",
     "UInt32", "UInt64", "Float32", "Float64")
)
_NULL_PART = np.frombuffer(struct.pack(">I", 1) + b"\x00", dtype=np.uint8)


def _segments_gather(buf: np.ndarray, starts: np.ndarray,
                     lens: np.ndarray) -> np.ndarray:
    """The byte segments buf[starts[i]:starts[i]+lens[i]], concatenated."""
    total = int(lens.sum())
    dst_start = np.cumsum(lens) - lens
    src = np.arange(total, dtype=np.int64) + np.repeat(starts - dst_start,
                                                       lens)
    return buf[src]


def _encode_numeric(data: np.ndarray, valid: np.ndarray, kind: str,
                    scale: int):
    """(bytes, per-row lengths) of `encode_scalar_bytes` over a numeric
    plane, length prefix included: the value widened to float64, the IEEE
    sign flip, big-endian."""
    if kind == "UInt64":
        data = data.view(np.uint64)
    f = data.astype(np.float64)
    if scale:
        f = f / (10 ** scale)
    bits = f.view(np.uint64)
    neg = (bits >> np.uint64(63)) == 1
    bits = np.where(neg, ~bits, bits ^ np.uint64(1 << 63))
    n = len(f)
    mat = np.empty((n, 13), dtype=np.uint8)
    mat[:, :5] = np.frombuffer(struct.pack(">I", 9) + b"\x01", np.uint8)
    mat[:, 5:] = bits.astype(">u8").view(np.uint8).reshape(n, 8)
    lens = np.full(n, 13, dtype=np.int64)
    if valid.all():
        return mat.reshape(-1), lens
    mat[~valid, :5] = _NULL_PART
    lens[~valid] = 5
    keep = np.arange(13)[None, :] < lens[:, None]
    return mat[keep], lens


def _encode_by_value(col, data: np.ndarray, valid: np.ndarray):
    """(bytes, per-row lengths) of `encode_scalar_bytes` for any other
    column: each distinct plane value made a Python value once
    (`Column.to_pylist`) and encoded once, then gathered by row."""
    import torch

    uniq, inv = np.unique(data[valid], return_inverse=True)
    host = type(col)(torch.from_numpy(np.ascontiguousarray(uniq)),
                     torch.ones(len(uniq), dtype=torch.bool), col.dtype,
                     col.dictionary)
    parts = [encode_key_bytes([v])
             for v in host.to_pylist(len(uniq))] + [_NULL_PART.tobytes()]
    table = np.frombuffer(b"".join(parts), dtype=np.uint8)
    part_lens = np.asarray([len(p) for p in parts], dtype=np.int64)
    part_starts = np.cumsum(part_lens) - part_lens
    code = np.full(len(data), len(parts) - 1, dtype=np.int64)
    code[valid] = inv.reshape(-1)
    lens = part_lens[code]
    return _segments_gather(table, part_starts[code], lens), lens


def encode_key_columns(columns: Sequence, num_rows: int):
    """`encode_key_bytes` of rows [0, num_rows) of the key columns, all at
    once in numpy: (the keys' bytes back to back, uint64 offsets of
    num_rows + 1). One host read of each column's planes; a numeric plane
    never becomes Python values."""
    parts = []
    for col in columns:
        data = col.data[:num_rows].cpu().numpy()
        valid = col.validity[:num_rows].cpu().numpy().astype(bool)
        kind = col.dtype.kind.value
        if col.dictionary is None and kind in _NUMERIC_KINDS:
            parts.append(_encode_numeric(data, valid, kind, 0))
        elif col.dictionary is None and kind == "Decimal128" \
                and col.dtype.params:
            parts.append(_encode_numeric(data, valid, kind,
                                         col.dtype.params[1]))
        else:
            parts.append(_encode_by_value(col, data, valid))
    lens = sum(p[1] for p in parts)
    offsets = np.zeros(num_rows + 1, dtype=np.uint64)
    offsets[1:] = np.cumsum(lens)
    out = np.empty(int(offsets[-1]), dtype=np.uint8)
    pos = offsets[:-1].astype(np.int64)
    for buf, plens in parts:
        src_start = np.cumsum(plens) - plens
        out[np.arange(len(buf), dtype=np.int64)
            + np.repeat(pos - src_start, plens)] = buf
        pos = pos + plens
    return out.tobytes(), offsets


class _NativeIndexBase(Index):
    _prefix = ""
    _has_range = False

    def __init__(self, unique: bool = False):
        lib = _load_library()
        if lib is None:
            raise IndexError_("native index library unavailable")
        self._lib = lib
        self.unique = unique
        self._handle = getattr(lib, f"qe_{self._prefix}_new")(1 if unique else 0)

    def __del__(self):
        lib = getattr(self, "_lib", None)
        h = getattr(self, "_handle", None)
        if lib is not None and h:
            try:
                getattr(lib, f"qe_{self._prefix}_free")(h)
            except Exception:  # noqa: BLE001 interpreter teardown
                pass
            self._handle = None

    def insert(self, key: Sequence, row_id: int) -> None:
        kb = encode_key_bytes(key)
        rc = getattr(self._lib, f"qe_{self._prefix}_insert")(
            self._handle, kb, len(kb), row_id
        )
        if rc != 0:
            raise IndexError_(
                f"unique constraint violation for key {tuple(key)}"
            )

    def bulk_load(self, pairs) -> None:
        keys = bytearray()
        offsets = [0]
        rows = []
        for key, rid in pairs:
            keys += encode_key_bytes(key)
            offsets.append(len(keys))
            rows.append(rid)
        n = len(rows)
        if n == 0:
            return
        off_arr = (ctypes.c_uint64 * (n + 1))(*offsets)
        row_arr = (ctypes.c_uint64 * n)(*rows)
        rc = getattr(self._lib, f"qe_{self._prefix}_bulk_insert")(
            self._handle, bytes(keys), off_arr, row_arr, n
        )
        if rc < 0:
            raise IndexError_("unique constraint violation in bulk load")

    def bulk_load_columns(self, columns: Sequence, num_rows: int,
                          start_row: int = 0) -> None:
        """The keys encoded in numpy (`encode_key_columns`) and inserted in
        row order by one native call."""
        if num_rows == 0:
            return
        keys, offsets = encode_key_columns(columns, num_rows)
        rows = np.arange(start_row, start_row + num_rows, dtype=np.uint64)
        p64 = ctypes.POINTER(ctypes.c_uint64)
        rc = getattr(self._lib, f"qe_{self._prefix}_bulk_insert")(
            self._handle, keys, offsets.ctypes.data_as(p64),
            rows.ctypes.data_as(p64), num_rows,
        )
        if rc < 0:
            raise IndexError_("unique constraint violation in bulk load")

    def delete(self, key: Sequence, row_id: int) -> None:
        kb = encode_key_bytes(key)
        getattr(self._lib, f"qe_{self._prefix}_delete")(
            self._handle, kb, len(kb), row_id
        )

    def lookup(self, key: Sequence) -> List[int]:
        kb = encode_key_bytes(key)
        cap = max(len(self), 16)
        out = (ctypes.c_uint64 * cap)()
        n = getattr(self._lib, f"qe_{self._prefix}_lookup")(
            self._handle, kb, len(kb), out, cap
        )
        return list(out[:n])

    def supports_range(self) -> bool:
        return self._has_range

    def __len__(self) -> int:
        return int(getattr(self._lib, f"qe_{self._prefix}_len")(self._handle))

    def clear(self) -> None:
        getattr(self._lib, f"qe_{self._prefix}_clear")(self._handle)


class NativeBTreeIndex(_NativeIndexBase):
    """C++ std::multimap over order-preserving keys (btree.rs parity)."""

    _prefix = "btree"
    _has_range = True

    def range_scan(self, low, high, include_low=True, include_high=True):
        cap = max(len(self), 16)
        out = (ctypes.c_uint64 * cap)()
        lo = encode_key_bytes(low) if low is not None else b""
        hi = encode_key_bytes(high) if high is not None else b""
        n = self._lib.qe_btree_range(
            self._handle,
            lo, len(lo) if low is not None else _UNBOUNDED,
            1 if include_low else 0,
            hi, len(hi) if high is not None else _UNBOUNDED,
            1 if include_high else 0,
            out, cap,
        )
        return list(out[:n])


class NativeHashIndex(_NativeIndexBase):
    """C++ std::unordered_multimap (hash.rs parity)."""

    _prefix = "hash"
    _has_range = False

    def range_scan(self, low, high, include_low=True, include_high=True):
        return []  # parity: hash indexes have no range support
