"""Index manager: name -> index + table -> index-name registries.

Parity surface: reference crates/query-index/src/manager.rs:19-273 —
create/drop/find-for-column/find-best-for-columns (longest prefix match,
manager.rs:221-240).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from query_engine_tpu_torch.core.errors import IndexError_
from query_engine_tpu_torch.index.btree import BTreeIndex
from query_engine_tpu_torch.index.hash import HashIndex
from query_engine_tpu_torch.index.types import Index, IndexMetadata


def _native_enabled() -> bool:
    import os

    if os.environ.get("QE_NO_NATIVE") == "1":
        return False
    from query_engine_tpu_torch.index import native

    return native.native_available()


class IndexManager:
    @staticmethod
    def _make_index(index_type: str, unique: bool) -> Index:
        """Prefer the C++ implementations (native/qe_native.cpp) — the
        reference's index crate is native too; fall back to pure Python."""
        if index_type not in ("hash", "btree"):
            raise IndexError_(f"unknown index type '{index_type}'")
        if _native_enabled():
            from query_engine_tpu_torch.index.native import (
                NativeBTreeIndex, NativeHashIndex,
            )

            return (
                NativeHashIndex(unique) if index_type == "hash"
                else NativeBTreeIndex(unique)
            )
        return HashIndex(unique) if index_type == "hash" else BTreeIndex(unique)

    def __init__(self):
        self._indexes: Dict[str, Index] = {}
        self._meta: Dict[str, IndexMetadata] = {}
        self._by_table: Dict[str, List[str]] = {}
        self._lock = threading.RLock()

    def create_index(
        self, name: str, table: str, columns: List[str],
        index_type: str = "btree", unique: bool = False,
    ) -> None:
        with self._lock:
            if name in self._indexes:
                raise IndexError_(f"index '{name}' already exists")
            idx = self._make_index(index_type, unique)
            self._indexes[name] = idx
            self._meta[name] = IndexMetadata(name, table, columns, index_type, unique)
            self._by_table.setdefault(table, []).append(name)

    def drop_index(self, name: str) -> None:
        with self._lock:
            meta = self._meta.pop(name, None)
            if meta is None:
                raise IndexError_(f"index '{name}' not found")
            self._indexes.pop(name, None)
            self._by_table.get(meta.table, []).remove(name)

    def has_index(self, name: str) -> bool:
        return name in self._indexes

    def get(self, name: str) -> Index:
        idx = self._indexes.get(name)
        if idx is None:
            raise IndexError_(f"index '{name}' not found")
        return idx

    def metadata(self, name: str) -> IndexMetadata:
        meta = self._meta.get(name)
        if meta is None:
            raise IndexError_(f"index '{name}' not found")
        return meta

    def table_indexes(self, table: str) -> List[str]:
        return list(self._by_table.get(table, ()))

    def list_indexes(self) -> List[IndexMetadata]:
        return list(self._meta.values())

    def find_for_column(self, table: str, column: str) -> Optional[str]:
        for name in self._by_table.get(table, ()):
            if self._meta[name].can_accelerate(column):
                return name
        return None

    def find_best_for_columns(
        self, table: str, columns: Sequence[str]
    ) -> Optional[str]:
        """Longest prefix match (manager.rs:221-240)."""
        best: Optional[str] = None
        best_len = 0
        for name in self._by_table.get(table, ()):
            meta = self._meta[name]
            # how many leading index columns are covered by the query columns
            n = 0
            for c in meta.columns:
                if c in columns:
                    n += 1
                else:
                    break
            if n > best_len:
                best, best_len = name, n
        return best

    def clear(self) -> None:
        with self._lock:
            self._indexes.clear()
            self._meta.clear()
            self._by_table.clear()
