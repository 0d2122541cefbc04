"""Index core types.

Parity surface: reference crates/query-index/src/types.rs:8-203 — the `Index`
trait (lookup/range_scan/insert/delete/supports_range/len/clear), order-
preserving `IndexKey` encoding (big-endian i64, f64 sign-flip :101-110), and
`IndexMetadata` with can_accelerate/covers_columns prefix logic.

Keys here are tuples of Python values; `encode_key` produces an
order-preserving comparable form (None sorts first, floats and ints share a
numeric order, strings compare lexicographically) — the same total order the
reference's byte encoding induces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple



def _encode_scalar(v) -> Tuple:
    """Order-preserving encoding of one scalar into a comparable tuple.

    Type tags keep heterogeneous values comparable: (0 null, 1 numeric,
    2 string). Floats use the sign-flip bit trick on the IEEE bits — the
    same trick as the reference IndexKey (types.rs:101-110) — so ints and
    floats order consistently via a float widening first.
    """
    if v is None:
        return (0, 0)
    if isinstance(v, bool):
        return (1, float(v))
    if isinstance(v, (int, float)):
        return (1, float(v))
    return (2, str(v))


def encode_key(values: Sequence) -> Tuple:
    return tuple(_encode_scalar(v) for v in values)


@dataclass
class IndexMetadata:
    """reference types.rs IndexMetadata."""

    name: str
    table: str
    columns: List[str]
    index_type: str  # "btree" | "hash"
    unique: bool = False

    def covers_columns(self, columns: Sequence[str]) -> bool:
        """Longest-prefix cover (manager.rs:221-240): the queried columns
        must be a prefix of the index columns."""
        if len(columns) > len(self.columns):
            return False
        return all(a == b for a, b in zip(self.columns, columns))

    def can_accelerate(self, column: str) -> bool:
        return bool(self.columns) and self.columns[0] == column


class Index:
    """Index interface (reference types.rs:152-182)."""

    def insert(self, key: Sequence, row_id: int) -> None:
        raise NotImplementedError

    def delete(self, key: Sequence, row_id: int) -> None:
        raise NotImplementedError

    def lookup(self, key: Sequence) -> List[int]:
        raise NotImplementedError

    def range_scan(
        self, low: Optional[Sequence], high: Optional[Sequence],
        include_low: bool = True, include_high: bool = True,
    ) -> List[int]:
        raise NotImplementedError

    def supports_range(self) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    def bulk_load(self, pairs: Sequence[Tuple[Sequence, int]]) -> None:
        for key, rid in pairs:
            self.insert(key, rid)

    def bulk_load_columns(self, columns: Sequence, num_rows: int,
                          start_row: int = 0) -> None:
        """Insert rows [0, num_rows) of the key columns (columnar `Column`s,
        one per key part) under row ids start_row + i: the keys as
        `Column.to_pylist` gives them, one read of each plane."""
        if num_rows == 0:
            return
        keys = zip(*[c.to_pylist(num_rows) for c in columns])
        self.bulk_load(zip(keys, range(start_row, start_row + num_rows)))
