"""Central error types.

Parity surface: reference crates/query-core/src/error.rs:4-57 (QueryError enum
with ParseError/PlanError/ExecutionError/SchemaError/TypeError/StorageError/
IndexError/CacheError/StreamError variants and a Result<T> alias).
"""

from __future__ import annotations


class QueryError(Exception):
    """Base error for the engine. `kind` mirrors the reference's enum variant."""

    kind = "QueryError"

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:  # e.g. "Parse error: unexpected token"
        return f"{self.kind}: {self.message}"


class ParseError(QueryError):
    kind = "Parse error"


class PlanError(QueryError):
    kind = "Plan error"


class ExecutionError(QueryError):
    kind = "Execution error"


class SchemaError(QueryError):
    kind = "Schema error"


class TypeError_(QueryError):
    kind = "Type error"


class StorageError(QueryError):
    kind = "Storage error"


class IndexError_(QueryError):
    kind = "Index error"


class CacheError(QueryError):
    kind = "Cache error"


class StreamError(QueryError):
    kind = "Stream error"


class DistributedError(QueryError):
    """Parity: reference crates/query-distributed/src/error.rs:7-58."""

    kind = "Distributed error"


class FlightError(QueryError):
    """Parity: reference crates/query-flight/src/error.rs:7-75."""

    kind = "Flight error"


class NotImplementedError_(QueryError):
    kind = "Not implemented"
