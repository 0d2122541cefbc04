"""Cache invalidation events.

Parity surface: reference crates/query-cache/src/invalidation.rs:7-68 —
CacheInvalidator trait + InvalidationEvent (TableModified/TableDropped/
SchemaChanged/All) + NoOp impl. Unlike the reference (where invalidation is
"not wired to DML anywhere", SURVEY §2.7), the Session wires
TableModified into every INSERT/UPDATE/DELETE.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class InvalidationKind(enum.Enum):
    TABLE_MODIFIED = "TableModified"
    TABLE_DROPPED = "TableDropped"
    SCHEMA_CHANGED = "SchemaChanged"
    ALL = "All"


@dataclass(frozen=True)
class InvalidationEvent:
    kind: InvalidationKind
    table: Optional[str] = None

    @staticmethod
    def table_modified(table: str) -> "InvalidationEvent":
        return InvalidationEvent(InvalidationKind.TABLE_MODIFIED, table)

    @staticmethod
    def table_dropped(table: str) -> "InvalidationEvent":
        return InvalidationEvent(InvalidationKind.TABLE_DROPPED, table)

    @staticmethod
    def all() -> "InvalidationEvent":
        return InvalidationEvent(InvalidationKind.ALL)


class CacheInvalidator:
    def handle_event(self, event: InvalidationEvent) -> None:
        raise NotImplementedError


class NoOpInvalidator(CacheInvalidator):
    def handle_event(self, event: InvalidationEvent) -> None:
        pass


class FullClearInvalidator(CacheInvalidator):
    """Clears the whole cache on any table event (correct + simple; per-table
    key tracking is a follow-up optimization)."""

    def __init__(self, cache):
        self.cache = cache

    def handle_event(self, event: InvalidationEvent) -> None:
        self.cache.clear()
