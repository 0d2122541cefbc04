"""State transfer: a ColumnBatch from host numpy planes.

`from_numpy_batch` rebuilds a batch from the planes of another
implementation's batch (the JAX package's `ColumnBatch` is the case the
differential tests use), so both engines hold the same tables. It reads the
fields by duck typing — `name`, `data_type.kind.name`, `data_type.params`,
`nullable` — and imports nothing of the other package; the caller turns its
planes into numpy first.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from query_engine_tpu_torch.core.errors import SchemaError
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity, to_tensor,
)
from query_engine_tpu_torch.columnar.dictionary import Dictionary

Plane = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


def _port_field(f) -> Field:
    dt = DataType(TypeKind[f.data_type.kind.name], tuple(f.data_type.params))
    return Field(f.name, dt, bool(f.nullable))


def from_numpy_batch(schema_fields: Sequence, planes: Sequence[Plane],
                     num_rows: int, device) -> ColumnBatch:
    """planes[i] = (data, validity, dictionary values or None) of field i,
    each at the batch's capacity (a power of two >= 128, pad rows invalid).
    Dictionary values must be the sorted unique strings the codes index."""
    fields = [_port_field(f) for f in schema_fields]
    if len(fields) != len(planes):
        raise SchemaError(
            f"{len(fields)} fields but {len(planes)} planes given"
        )
    cols = []
    for f, (data, validity, dict_values) in zip(fields, planes):
        data = np.asarray(data)
        validity = np.asarray(validity, dtype=bool)
        if data.shape != validity.shape or data.ndim != 1:
            raise SchemaError(f"column '{f.name}': data and validity planes "
                              f"differ: {data.shape} vs {validity.shape}")
        if data.shape[0] != padded_capacity(max(num_rows, data.shape[0])):
            raise SchemaError(f"column '{f.name}': capacity {data.shape[0]} "
                              "is not a power of two >= 128")
        dictionary = None
        if dict_values is not None:
            dictionary = Dictionary.from_sorted(
                np.asarray(dict_values, dtype=object)
            )
        cols.append(Column(
            to_tensor(data.astype(f.data_type.device_dtype, copy=False), device),
            to_tensor(validity, device),
            f.data_type, dictionary,
        ))
    return ColumnBatch(Schema(fields), cols, num_rows)
