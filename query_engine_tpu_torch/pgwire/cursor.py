"""Cursors and portals: row-offset pagination over materialized results.

Parity surface: reference crates/query-pgwire/src/cursor.rs:13-160 (DECLARE/
FETCH/CLOSE slice-based fetch) and portal.rs:14-160 (extended-protocol
portals with max_rows suspension).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.errors import ExecutionError


@dataclass
class Cursor:
    name: str
    result: ColumnBatch
    position: int = 0

    def fetch(self, n: Optional[int]) -> ColumnBatch:
        """Slice-based fetch (cursor.rs fetch)."""
        remaining = self.result.num_rows - self.position
        take = remaining if n is None else min(n, remaining)
        out = self.result.slice(self.position, take)
        self.position += take
        return out

    @property
    def exhausted(self) -> bool:
        return self.position >= self.result.num_rows


class CursorStore:
    def __init__(self):
        self._cursors: Dict[str, Cursor] = {}
        self._lock = threading.RLock()

    def declare(self, name: str, result: ColumnBatch) -> None:
        with self._lock:
            if name in self._cursors:
                raise ExecutionError(f"cursor \"{name}\" already exists")
            self._cursors[name] = Cursor(name, result)

    def fetch(self, name: str, n: Optional[int]) -> ColumnBatch:
        with self._lock:
            cur = self._cursors.get(name)
            if cur is None:
                raise ExecutionError(f"cursor \"{name}\" does not exist")
            return cur.fetch(n)

    def close(self, name: str) -> None:
        with self._lock:
            if name not in self._cursors:
                raise ExecutionError(f"cursor \"{name}\" does not exist")
            del self._cursors[name]

    def close_all(self) -> None:
        with self._lock:
            self._cursors.clear()


@dataclass
class PreparedStatement:
    name: str
    query: str
    param_oids: list = field(default_factory=list)


@dataclass
class Portal:
    name: str
    statement: PreparedStatement
    params: list = field(default_factory=list)
    result: Optional[ColumnBatch] = None
    position: int = 0

    def fetch(self, max_rows: int) -> tuple:
        """Returns (batch, suspended)."""
        assert self.result is not None
        remaining = self.result.num_rows - self.position
        take = remaining if max_rows <= 0 else min(max_rows, remaining)
        out = self.result.slice(self.position, take)
        self.position += take
        suspended = self.position < self.result.num_rows
        return out, suspended
