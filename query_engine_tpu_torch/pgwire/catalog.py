"""pg_catalog / information_schema shims.

Parity surface: reference crates/query-pgwire/src/catalog.rs:27-379 —
hard-coded pg_tables / pg_attribute / pg_type / information_schema.columns
responses synthesized from the registered table map, plus version() /
current_schema() / SHOW answers (backend.rs:834-850).
"""

from __future__ import annotations

import re
from typing import Optional

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.pgwire.result import type_oid

SERVER_VERSION = "14.0 (query-engine-tpu 0.1)"

_PG_TYPE_NAMES = {
    TypeKind.BOOLEAN: "bool",
    TypeKind.INT16: "int2",
    TypeKind.INT32: "int4",
    TypeKind.INT64: "int8",
    TypeKind.FLOAT32: "float4",
    TypeKind.FLOAT64: "float8",
    TypeKind.UTF8: "text",
    TypeKind.DATE32: "date",
    TypeKind.TIMESTAMP: "timestamp",
    TypeKind.DECIMAL128: "numeric",
    TypeKind.JSON: "json",
    TypeKind.UUID: "uuid",
}


def pg_type_name(dt: DataType) -> str:
    return _PG_TYPE_NAMES.get(dt.kind, "text")


def handle_catalog_query(session, sql: str) -> Optional[ColumnBatch]:
    """Returns a synthetic result for catalog-ish queries, else None."""
    q = " ".join(sql.lower().split())

    if re.search(r"\bversion\s*\(\s*\)", q):
        return ColumnBatch.from_pydict({"version": [f"PostgreSQL {SERVER_VERSION}"]})
    if "current_schema" in q:
        return ColumnBatch.from_pydict({"current_schema": ["public"]})
    if "current_database" in q:
        return ColumnBatch.from_pydict({"current_database": ["qe"]})

    if "pg_catalog.pg_tables" in q or re.search(r"\bfrom pg_tables\b", q):
        names = session.tables()
        return ColumnBatch.from_pydict(
            {
                "schemaname": ["public"] * len(names),
                "tablename": names,
                "tableowner": ["qe"] * len(names),
            }
        )

    if "pg_catalog.pg_views" in q or re.search(r"\bfrom pg_views\b", q):
        names = session.views()
        return ColumnBatch.from_pydict(
            {
                "schemaname": ["public"] * len(names),
                "viewname": names,
                "viewowner": ["qe"] * len(names),
            }
        )

    if "pg_catalog.pg_type" in q or re.search(r"\bfrom pg_type\b", q):
        kinds = sorted(_PG_TYPE_NAMES.values())
        oids = [type_oid(DataType(k)) for k in _PG_TYPE_NAMES]
        return ColumnBatch.from_pydict(
            {"oid": oids, "typname": list(_PG_TYPE_NAMES.values())}
        )

    if "pg_catalog.pg_attribute" in q or re.search(r"\bfrom pg_attribute\b", q):
        rows = {"attrelid": [], "attname": [], "atttypid": [], "attnum": []}
        for t_i, name in enumerate(session.tables()):
            schema = session.table_schema(name)
            for c_i, f in enumerate(schema):
                rows["attrelid"].append(t_i + 16384)
                rows["attname"].append(f.name.rsplit(".", 1)[-1])
                rows["atttypid"].append(type_oid(f.data_type))
                rows["attnum"].append(c_i + 1)
        return ColumnBatch.from_pydict(rows)

    if "information_schema.tables" in q:
        names = session.tables()
        views = session.views()
        return ColumnBatch.from_pydict(
            {
                "table_catalog": ["qe"] * (len(names) + len(views)),
                "table_schema": ["public"] * (len(names) + len(views)),
                "table_name": names + views,
                "table_type": (["BASE TABLE"] * len(names)
                               + ["VIEW"] * len(views)),
            }
        )

    if "information_schema.columns" in q:
        rows = {
            "table_schema": [], "table_name": [], "column_name": [],
            "ordinal_position": [], "data_type": [], "is_nullable": [],
        }
        m = re.search(r"table_name\s*=\s*'([^']+)'", q)
        names = [m.group(1)] if m else session.tables() + session.views()
        for name in names:
            try:
                schema = session.table_schema(name)
            except KeyError:
                continue
            for c_i, f in enumerate(schema):
                rows["table_schema"].append("public")
                rows["table_name"].append(name)
                rows["column_name"].append(f.name.rsplit(".", 1)[-1])
                rows["ordinal_position"].append(c_i + 1)
                rows["data_type"].append(pg_type_name(f.data_type))
                rows["is_nullable"].append("YES" if f.nullable else "NO")
        return ColumnBatch.from_pydict(rows)

    if "pg_catalog" in q or "pg_namespace" in q or "pg_class" in q:
        # unrecognized catalog query: empty, not an error (psql startup noise)
        return ColumnBatch.from_pydict({"?column?": []})

    return None
