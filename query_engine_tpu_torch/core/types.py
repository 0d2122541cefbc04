"""Engine-level data types with bidirectional Arrow + device-dtype mapping.

Parity surface: reference crates/query-core/src/types.rs:5-126 (`DataType` enum
including PG extension types — Uuid, Decimal128, Interval, Json, List, seven
geometric types, Enum, TsVector/TsQuery — with to_arrow/from_arrow).

Device representation: every type lowers to a fixed-width device lane dtype
(`device_dtype`). Variable-width types (Utf8, Json, TsVector, ...) are
dictionary-encoded at ingest: the device plane holds int32 codes into a
host-side sorted dictionary, so code order == lexicographic order and ORDER
BY / GROUP BY / joins on strings run entirely on-device (SURVEY.md §7
"Strings" hard-part #3).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover - pyarrow is baked into the image
    pa = None


class TypeKind(enum.Enum):
    BOOLEAN = "Boolean"
    INT8 = "Int8"
    INT16 = "Int16"
    INT32 = "Int32"
    INT64 = "Int64"
    UINT8 = "UInt8"
    UINT16 = "UInt16"
    UINT32 = "UInt32"
    UINT64 = "UInt64"
    FLOAT32 = "Float32"
    FLOAT64 = "Float64"
    UTF8 = "Utf8"
    DATE32 = "Date32"
    DATE64 = "Date64"
    TIMESTAMP = "Timestamp"
    # PG extension types (reference types.rs:20-43)
    UUID = "Uuid"
    DECIMAL128 = "Decimal128"
    INTERVAL = "Interval"
    JSON = "Json"
    LIST = "List"
    POINT = "Point"
    LINE = "Line"
    LSEG = "LSeg"
    BOX = "Box"
    PATH = "Path"
    POLYGON = "Polygon"
    CIRCLE = "Circle"
    ENUM = "Enum"
    TSVECTOR = "TsVector"
    TSQUERY = "TsQuery"
    NULL = "Null"


# Types whose device plane is an int32 dictionary code into a host dictionary.
_DICT_KINDS = frozenset(
    {
        TypeKind.UTF8,
        TypeKind.UUID,
        TypeKind.JSON,
        TypeKind.LIST,
        TypeKind.POINT,
        TypeKind.LINE,
        TypeKind.LSEG,
        TypeKind.BOX,
        TypeKind.PATH,
        TypeKind.POLYGON,
        TypeKind.CIRCLE,
        TypeKind.ENUM,
        TypeKind.TSVECTOR,
        TypeKind.TSQUERY,
    }
)

_NUMPY_DTYPES = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.INT8: np.dtype(np.int8),
    TypeKind.INT16: np.dtype(np.int16),
    TypeKind.INT32: np.dtype(np.int32),
    TypeKind.INT64: np.dtype(np.int64),
    TypeKind.UINT8: np.dtype(np.uint8),
    TypeKind.UINT16: np.dtype(np.uint16),
    TypeKind.UINT32: np.dtype(np.uint32),
    TypeKind.UINT64: np.dtype(np.uint64),
    TypeKind.FLOAT32: np.dtype(np.float32),
    TypeKind.FLOAT64: np.dtype(np.float64),
    TypeKind.DATE32: np.dtype(np.int32),
    TypeKind.DATE64: np.dtype(np.int64),
    TypeKind.TIMESTAMP: np.dtype(np.int64),
    TypeKind.DECIMAL128: np.dtype(np.int64),  # scaled int64 lane (p<=18)
    TypeKind.INTERVAL: np.dtype(np.int64),  # microseconds
    TypeKind.NULL: np.dtype(np.int8),
}


@dataclass(frozen=True)
class DataType:
    """An engine data type. `params` carries e.g. Decimal (precision, scale)."""

    kind: TypeKind
    params: Tuple = ()

    # ---- constructors -------------------------------------------------
    @staticmethod
    def boolean() -> "DataType":
        return DataType(TypeKind.BOOLEAN)

    @staticmethod
    def int8() -> "DataType":
        return DataType(TypeKind.INT8)

    @staticmethod
    def int16() -> "DataType":
        return DataType(TypeKind.INT16)

    @staticmethod
    def int32() -> "DataType":
        return DataType(TypeKind.INT32)

    @staticmethod
    def int64() -> "DataType":
        return DataType(TypeKind.INT64)

    @staticmethod
    def float32() -> "DataType":
        return DataType(TypeKind.FLOAT32)

    @staticmethod
    def float64() -> "DataType":
        return DataType(TypeKind.FLOAT64)

    @staticmethod
    def utf8() -> "DataType":
        return DataType(TypeKind.UTF8)

    @staticmethod
    def date32() -> "DataType":
        return DataType(TypeKind.DATE32)

    @staticmethod
    def timestamp() -> "DataType":
        return DataType(TypeKind.TIMESTAMP)

    @staticmethod
    def decimal128(precision: int, scale: int) -> "DataType":
        return DataType(TypeKind.DECIMAL128, (precision, scale))

    @staticmethod
    def list_(inner: "DataType") -> "DataType":
        return DataType(TypeKind.LIST, (inner,))

    @staticmethod
    def enum(name: str, values: Tuple[str, ...]) -> "DataType":
        return DataType(TypeKind.ENUM, (name, tuple(values)))

    @staticmethod
    def null() -> "DataType":
        return DataType(TypeKind.NULL)

    # ---- predicates ---------------------------------------------------
    @property
    def is_dictionary(self) -> bool:
        return self.kind in _DICT_KINDS

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            TypeKind.INT8,
            TypeKind.INT16,
            TypeKind.INT32,
            TypeKind.INT64,
            TypeKind.UINT8,
            TypeKind.UINT16,
            TypeKind.UINT32,
            TypeKind.UINT64,
            TypeKind.FLOAT32,
            TypeKind.FLOAT64,
            TypeKind.DECIMAL128,
        )

    @property
    def is_integer(self) -> bool:
        return self.kind in (
            TypeKind.INT8,
            TypeKind.INT16,
            TypeKind.INT32,
            TypeKind.INT64,
            TypeKind.UINT8,
            TypeKind.UINT16,
            TypeKind.UINT32,
            TypeKind.UINT64,
        )

    @property
    def is_float(self) -> bool:
        return self.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)

    @property
    def is_temporal(self) -> bool:
        return self.kind in (TypeKind.DATE32, TypeKind.DATE64, TypeKind.TIMESTAMP)

    # ---- lowering -----------------------------------------------------
    @property
    def device_dtype(self) -> np.dtype:
        """The fixed-width dtype of this type's device plane."""
        if self.is_dictionary:
            return np.dtype(np.int32)
        return _NUMPY_DTYPES[self.kind]

    # ---- Arrow mapping (reference types.rs:46-126) --------------------
    def to_arrow(self):
        if pa is None:
            raise RuntimeError("pyarrow unavailable")
        k = self.kind
        simple = {
            TypeKind.BOOLEAN: pa.bool_(),
            TypeKind.INT8: pa.int8(),
            TypeKind.INT16: pa.int16(),
            TypeKind.INT32: pa.int32(),
            TypeKind.INT64: pa.int64(),
            TypeKind.UINT8: pa.uint8(),
            TypeKind.UINT16: pa.uint16(),
            TypeKind.UINT32: pa.uint32(),
            TypeKind.UINT64: pa.uint64(),
            TypeKind.FLOAT32: pa.float32(),
            TypeKind.FLOAT64: pa.float64(),
            TypeKind.UTF8: pa.string(),
            TypeKind.DATE32: pa.date32(),
            TypeKind.DATE64: pa.date64(),
            TypeKind.TIMESTAMP: pa.timestamp("us"),
            TypeKind.UUID: pa.string(),
            TypeKind.INTERVAL: pa.duration("us"),
            TypeKind.JSON: pa.string(),
            TypeKind.POINT: pa.string(),
            TypeKind.LINE: pa.string(),
            TypeKind.LSEG: pa.string(),
            TypeKind.BOX: pa.string(),
            TypeKind.PATH: pa.string(),
            TypeKind.POLYGON: pa.string(),
            TypeKind.CIRCLE: pa.string(),
            TypeKind.ENUM: pa.string(),
            TypeKind.TSVECTOR: pa.string(),
            TypeKind.TSQUERY: pa.string(),
            TypeKind.NULL: pa.null(),
        }
        if k is TypeKind.DECIMAL128:
            p, s = self.params
            return pa.decimal128(p, s)
        if k is TypeKind.LIST:
            return pa.list_(self.params[0].to_arrow())
        return simple[k]

    @staticmethod
    def from_arrow(arrow_type) -> "DataType":
        if pa is None:
            raise RuntimeError("pyarrow unavailable")
        t = arrow_type
        if pa.types.is_boolean(t):
            return DataType.boolean()
        if pa.types.is_int8(t):
            return DataType.int8()
        if pa.types.is_int16(t):
            return DataType.int16()
        if pa.types.is_int32(t):
            return DataType.int32()
        if pa.types.is_int64(t):
            return DataType.int64()
        if pa.types.is_uint8(t):
            return DataType(TypeKind.UINT8)
        if pa.types.is_uint16(t):
            return DataType(TypeKind.UINT16)
        if pa.types.is_uint32(t):
            return DataType(TypeKind.UINT32)
        if pa.types.is_uint64(t):
            return DataType(TypeKind.UINT64)
        if pa.types.is_float32(t):
            return DataType.float32()
        if pa.types.is_float64(t):
            return DataType.float64()
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            return DataType.utf8()
        if pa.types.is_date32(t):
            return DataType.date32()
        if pa.types.is_date64(t):
            return DataType(TypeKind.DATE64)
        if pa.types.is_timestamp(t):
            return DataType.timestamp()
        if pa.types.is_decimal(t):
            return DataType.decimal128(t.precision, t.scale)
        if pa.types.is_list(t):
            return DataType.list_(DataType.from_arrow(t.value_type))
        if pa.types.is_duration(t):
            return DataType(TypeKind.INTERVAL)
        if pa.types.is_null(t):
            return DataType.null()
        if pa.types.is_dictionary(t):
            return DataType.from_arrow(t.value_type)
        raise ValueError(f"unsupported arrow type: {t}")

    def __str__(self) -> str:
        if self.kind is TypeKind.DECIMAL128 and self.params:
            return f"Decimal128({self.params[0]},{self.params[1]})"
        return self.kind.value


@dataclass
class ColumnInfo:
    """Column metadata (reference types.rs `ColumnInfo`)."""

    name: str
    data_type: DataType
    nullable: bool = True
    metadata: dict = field(default_factory=dict)
