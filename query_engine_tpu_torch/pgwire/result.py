"""Engine types -> PG wire encoding.

Parity surface: reference crates/query-pgwire/src/result.rs:11-176 —
Arrow->PG type map and RecordBatch->DataRow encoders (Date32/Date64 via
chrono).
"""

from __future__ import annotations

import datetime
from typing import List, Optional

from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.pgwire.protocol import FieldInfo

# PostgreSQL type OIDs
OID_BOOL = 16
OID_INT8 = 20
OID_INT2 = 21
OID_INT4 = 23
OID_TEXT = 25
OID_JSON = 114
OID_FLOAT4 = 700
OID_FLOAT8 = 701
OID_VARCHAR = 1043
OID_DATE = 1082
OID_TIMESTAMP = 1114
OID_INTERVAL = 1186
OID_NUMERIC = 1700
OID_UUID = 2950

_OID_MAP = {
    TypeKind.BOOLEAN: OID_BOOL,
    TypeKind.INT8: OID_INT2,
    TypeKind.INT16: OID_INT2,
    TypeKind.INT32: OID_INT4,
    TypeKind.INT64: OID_INT8,
    TypeKind.UINT8: OID_INT2,
    TypeKind.UINT16: OID_INT4,
    TypeKind.UINT32: OID_INT8,
    TypeKind.UINT64: OID_NUMERIC,
    TypeKind.FLOAT32: OID_FLOAT4,
    TypeKind.FLOAT64: OID_FLOAT8,
    TypeKind.UTF8: OID_TEXT,
    TypeKind.DATE32: OID_DATE,
    TypeKind.DATE64: OID_TIMESTAMP,
    TypeKind.TIMESTAMP: OID_TIMESTAMP,
    TypeKind.UUID: OID_UUID,
    TypeKind.DECIMAL128: OID_NUMERIC,
    TypeKind.INTERVAL: OID_INTERVAL,
    TypeKind.JSON: OID_JSON,
    TypeKind.NULL: OID_TEXT,
}


def type_oid(dt: DataType) -> int:
    return _OID_MAP.get(dt.kind, OID_TEXT)


def schema_to_field_info(schema) -> List[FieldInfo]:
    """reference result.rs schema_to_field_info (:36-54)."""
    out = []
    for f in schema:
        name = f.name.rsplit(".", 1)[-1]
        out.append(FieldInfo(name, type_oid(f.data_type)))
    return out


_EPOCH_DATE = datetime.date(1970, 1, 1)


def encode_value(v, dt: DataType) -> Optional[bytes]:
    """Text-format encoding of one value (result.rs:56-176)."""
    if v is None:
        return None
    k = dt.kind
    if k is TypeKind.BOOLEAN:
        return b"t" if v else b"f"
    if k is TypeKind.DATE32:
        if not isinstance(v, datetime.date):
            v = _EPOCH_DATE + datetime.timedelta(days=int(v))
        return v.isoformat().encode()
    if k is TypeKind.TIMESTAMP or k is TypeKind.DATE64:
        if not isinstance(v, datetime.datetime):
            us = int(v) if k is TypeKind.TIMESTAMP else int(v) * 1000
            v = datetime.datetime(1970, 1, 1) + datetime.timedelta(
                microseconds=us
            )
        return v.isoformat(sep=" ").encode()
    if k is TypeKind.FLOAT32 or k is TypeKind.FLOAT64:
        return repr(float(v)).encode()
    if k is TypeKind.LIST and isinstance(v, (list, tuple)):
        # PG array text format: {elem,elem,...} with NULL and quoted strings
        def el(x):
            if x is None:
                return "NULL"
            if isinstance(x, str):
                return '"' + x.replace("\\", "\\\\").replace('"', '\\"') + '"'
            if isinstance(x, bool):
                return "t" if x else "f"
            return repr(x) if isinstance(x, float) else str(x)

        return ("{" + ",".join(el(x) for x in v) + "}").encode()
    if isinstance(v, float):
        return repr(v).encode()
    return str(v).encode()


def batch_to_data_rows(batch: ColumnBatch) -> List[List[Optional[bytes]]]:
    """reference result.rs record_batch_to_rows (:56-79). The planes come
    to the host in one transfer (`host_pylists`), with the same values as
    `Column.to_pylist`, so the text is the JAX server's byte for byte."""
    cols = [
        (vals, f.data_type)
        for vals, f in zip(batch.host_pylists(), batch.schema)
    ]
    rows = []
    for i in range(batch.num_rows):
        rows.append([encode_value(vals[i], dt) for vals, dt in cols])
    return rows
