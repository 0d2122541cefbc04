"""Hash index: O(1) equality lookups, no range support.

Parity surface: reference crates/query-index/src/hash.rs:18-140 —
RwLock<AHashMap<IndexKey, Vec<usize>>>; range_scan returns empty.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

from query_engine_tpu_torch.core.errors import IndexError_
from query_engine_tpu_torch.index.types import Index, encode_key


class HashIndex(Index):
    def __init__(self, unique: bool = False):
        self.unique = unique
        self._map: Dict[Tuple, List[int]] = {}
        self._len = 0
        self._lock = threading.RLock()

    def insert(self, key: Sequence, row_id: int) -> None:
        ek = encode_key(key)
        with self._lock:
            rows = self._map.get(ek)
            if rows is None:
                self._map[ek] = [row_id]
            else:
                if self.unique:
                    raise IndexError_(
                        f"unique constraint violation for key {tuple(key)}"
                    )
                rows.append(row_id)
            self._len += 1

    def delete(self, key: Sequence, row_id: int) -> None:
        ek = encode_key(key)
        with self._lock:
            rows = self._map.get(ek)
            if not rows or row_id not in rows:
                return
            rows.remove(row_id)
            self._len -= 1
            if not rows:
                del self._map[ek]

    def lookup(self, key: Sequence) -> List[int]:
        ek = encode_key(key)
        with self._lock:
            return list(self._map.get(ek, ()))

    def range_scan(self, low, high, include_low=True, include_high=True):
        return []  # parity: hash.rs range_scan -> empty

    def supports_range(self) -> bool:
        return False

    def __len__(self) -> int:
        return self._len

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._len = 0
