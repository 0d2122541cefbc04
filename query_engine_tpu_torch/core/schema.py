"""Schema: named/typed/nullable field list with index lookup + Arrow conversion.

Parity surface: reference crates/query-core/src/schema.rs:6-93
(`Field`, `Schema::{index_of,field_with_name,to_arrow,from_arrow}`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from query_engine_tpu_torch.core.errors import SchemaError
from query_engine_tpu_torch.core.types import DataType

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


@dataclass(frozen=True)
class Field:
    name: str
    data_type: DataType
    nullable: bool = True

    def to_arrow(self):
        return pa.field(self.name, self.data_type.to_arrow(), self.nullable)

    @staticmethod
    def from_arrow(f) -> "Field":
        return Field(f.name, DataType.from_arrow(f.type), f.nullable)

    def with_name(self, name: str) -> "Field":
        return Field(name, self.data_type, self.nullable)


@dataclass(frozen=True)
class Schema:
    fields: tuple

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def field(self, i: int) -> Field:
        return self.fields[i]

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        """Exact-name lookup; raises SchemaError if absent (schema.rs:39-56)."""
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise SchemaError(f"column '{name}' not found in schema {self.names()}")

    def try_index_of(self, name: str) -> Optional[int]:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        return None

    def field_with_name(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def project(self, indices) -> "Schema":
        return Schema([self.fields[i] for i in indices])

    def merge(self, other: "Schema") -> "Schema":
        """Join-style schema concatenation (reference planner.rs:329-343)."""
        return Schema(list(self.fields) + list(other.fields))

    def to_arrow(self):
        return pa.schema([f.to_arrow() for f in self.fields])

    @staticmethod
    def from_arrow(s) -> "Schema":
        return Schema([Field.from_arrow(f) for f in s])

    def __str__(self) -> str:
        cols = ", ".join(f"{f.name}: {f.data_type}" for f in self.fields)
        return f"Schema[{cols}]"
