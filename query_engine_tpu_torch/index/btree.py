"""B-Tree index: sorted-order structure with range scans.

Parity surface: reference crates/query-index/src/btree.rs:16-152 —
RwLock<BTreeMap<IndexKey, Vec<usize>>>, inclusive range scans, unique-
constraint enforcement, bulk_load.

Implementation: sorted key list + key->row-ids map maintained with bisect
(O(log n) search, O(n) insert — fine for host-side index maintenance; the
device engine does the heavy scans). A C++ backing store can swap in behind
this API without changing callers.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from query_engine_tpu_torch.core.errors import IndexError_
from query_engine_tpu_torch.index.types import Index, encode_key


class BTreeIndex(Index):
    def __init__(self, unique: bool = False):
        self.unique = unique
        self._keys: List[Tuple] = []  # sorted encoded keys (unique)
        self._map: Dict[Tuple, List[int]] = {}
        self._len = 0
        self._lock = threading.RLock()

    def insert(self, key: Sequence, row_id: int) -> None:
        ek = encode_key(key)
        with self._lock:
            rows = self._map.get(ek)
            if rows is None:
                bisect.insort(self._keys, ek)
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
                i = bisect.bisect_left(self._keys, ek)
                if i < len(self._keys) and self._keys[i] == ek:
                    self._keys.pop(i)

    def lookup(self, key: Sequence) -> List[int]:
        ek = encode_key(key)
        with self._lock:
            return list(self._map.get(ek, ()))

    def range_scan(
        self, low: Optional[Sequence], high: Optional[Sequence],
        include_low: bool = True, include_high: bool = True,
    ) -> List[int]:
        with self._lock:
            if low is None:
                i = 0
            else:
                el = encode_key(low)
                i = (
                    bisect.bisect_left(self._keys, el)
                    if include_low else bisect.bisect_right(self._keys, el)
                )
            if high is None:
                j = len(self._keys)
            else:
                eh = encode_key(high)
                j = (
                    bisect.bisect_right(self._keys, eh)
                    if include_high else bisect.bisect_left(self._keys, eh)
                )
            out: List[int] = []
            for k in self._keys[i:j]:
                out.extend(self._map[k])
            return out

    def supports_range(self) -> bool:
        return True

    def __len__(self) -> int:
        return self._len

    def clear(self) -> None:
        with self._lock:
            self._keys.clear()
            self._map.clear()
            self._len = 0
