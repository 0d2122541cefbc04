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
