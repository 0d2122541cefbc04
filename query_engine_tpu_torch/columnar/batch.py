"""ColumnBatch: the engine's columnar batch (Arrow RecordBatch analog).

Layout, the same contract as `query_engine_tpu.columnar.batch`:
  * a batch is a list of fixed-width 1-D torch planes, one per column, all
    padded to the same power-of-two `capacity` (>=128);
  * nulls are a separate boolean validity plane per column (Arrow null
    bitmap analog) — never sentinel values. Pad rows are invalid;
  * the live row count `num_rows` is a host int: rows [0, num_rows) are
    live, operators mask the pad tail with `live_mask()`;
  * strings and other variable-width types are int32 codes into a sorted
    host-side `Dictionary` (see columnar/dictionary.py).

Every plane of a batch lies on one torch device. Encoding happens on the
host in numpy; `from_pydict`/`from_arrow`/`empty` take the target device,
and `to(device)` moves a batch.

Parity surface: Arrow RecordBatch semantics as used throughout the reference
(e.g. query-executor/src/executor.rs operates on Vec<RecordBatch>; selection
is `filter_record_batch` executor.rs:131-155, row movement is
`arrow::compute::take` partition.rs:292-316).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import ExecutionError, SchemaError
from query_engine_tpu_torch.core.schema import Field, Schema
from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.dictionary import Dictionary, merge_many
from query_engine_tpu_torch.utils.profiling import span

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

CAPACITY_MIN = 128


def padded_capacity(n: int) -> int:
    """Pad row counts to power-of-two buckets (>=128)."""
    if n <= CAPACITY_MIN:
        return CAPACITY_MIN
    return 1 << (int(n - 1).bit_length())


def _pad_1d(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    if len(arr) == capacity:
        return arr
    if len(arr) > capacity:
        raise ExecutionError(f"array of {len(arr)} rows exceeds capacity {capacity}")
    out = np.full(capacity, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def _pad_t(t: torch.Tensor, capacity: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to `capacity` (False for bool planes)."""
    n = t.shape[0]
    if n == capacity:
        return t
    if n > capacity:
        raise ExecutionError(f"array of {n} rows exceeds capacity {capacity}")
    out = torch.zeros(capacity, dtype=t.dtype, device=t.device)
    out[:n] = t
    return out


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Host numpy plane -> torch tensor on `device`. Unsigned planes wider
    than 8 bits ride as int64 (torch's uint16/32/64 lack most ops); UINT64
    keeps its bits and wraps like two's complement."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    elif arr.dtype in (np.uint16, np.uint32):
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr).to(device)


def host_pylist(data: np.ndarray, valid: np.ndarray, dtype: DataType,
                dictionary: Optional[Dictionary] = None) -> list:
    """A column's live rows as Python values (None for NULL), from its data
    and validity planes already on the host."""
    if dictionary is not None:
        vals = dictionary.values
        out = [
            vals[c] if v and 0 <= c < len(vals) else None
            for c, v in zip(data.tolist(), valid.tolist())
        ]
        return out
    k = dtype.kind
    if k is TypeKind.UINT64:
        data = data.view(np.uint64)
    if k is TypeKind.DATE32:
        import datetime

        epoch = datetime.date(1970, 1, 1)
        return [
            epoch + datetime.timedelta(days=int(x)) if v else None
            for x, v in zip(data.tolist(), valid.tolist())
        ]
    if k is TypeKind.TIMESTAMP or k is TypeKind.DATE64:
        import datetime

        epoch = datetime.datetime(1970, 1, 1)
        mult = 1 if k is TypeKind.TIMESTAMP else 1000
        return [
            epoch + datetime.timedelta(microseconds=int(x) * mult)
            if v else None
            for x, v in zip(data.tolist(), valid.tolist())
        ]
    if k is TypeKind.DECIMAL128 and dtype.params:
        scale = dtype.params[1]
        return [
            (int(x) / (10**scale)) if v else None
            for x, v in zip(data.tolist(), valid.tolist())
        ]
    return [x if v else None for x, v in zip(data.tolist(), valid.tolist())]


@dataclass
class Column:
    """One column: data plane + validity plane (+ dictionary for strings)."""

    data: torch.Tensor  # (capacity,)
    validity: torch.Tensor  # (capacity,) bool; True = non-null
    dtype: DataType
    dictionary: Optional[Dictionary] = None

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def np_data(self) -> np.ndarray:
        return self.data.cpu().numpy()

    def np_validity(self) -> np.ndarray:
        return self.validity.cpu().numpy()

    def to(self, device) -> "Column":
        return Column(self.data.to(device), self.validity.to(device),
                      self.dtype, self.dictionary)

    def to_pylist(self, num_rows: int) -> list:
        return host_pylist(self.data[:num_rows].cpu().numpy(),
                           self.validity[:num_rows].cpu().numpy(),
                           self.dtype, self.dictionary)

    def take_host(self, indices: np.ndarray, capacity: int) -> "Column":
        """Gather rows by host-side indices (slicing/limit paths); the
        gather runs on the column's device."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                              device=self.data.device)
        return Column(
            _pad_t(self.data[idx], capacity),
            _pad_t(self.validity[idx], capacity),
            self.dtype,
            self.dictionary,
        )


def _infer_type(values: Sequence) -> DataType:
    if isinstance(values, np.ndarray) and values.dtype != object:
        if values.dtype == np.bool_:
            return DataType.boolean()
        if np.issubdtype(values.dtype, np.integer):
            return DataType.int64()
        if np.issubdtype(values.dtype, np.floating):
            return DataType.float64()
        if values.dtype.kind in ("U", "S"):
            return DataType.utf8()
    for v in values:
        if v is None:
            continue
        if isinstance(v, bool):
            return DataType.boolean()
        if isinstance(v, (int, np.integer)):
            return DataType.int64()
        if isinstance(v, (float, np.floating)):
            return DataType.float64()
        if isinstance(v, str):
            return DataType.utf8()
    return DataType.utf8()


def _temporal_ints(values: list, dtype: DataType) -> list:
    """DATE32 / TIMESTAMP values given as `datetime.date`, `datetime.datetime`
    or ISO strings (an INSERT's `DATE '...'` literal) as the plane's integer
    days or microseconds; other values pass through. The JAX package's
    encoder takes only integers here."""
    import datetime

    k = dtype.kind
    if k not in (TypeKind.DATE32, TypeKind.TIMESTAMP):
        return values
    epoch = datetime.datetime(1970, 1, 1)
    out = []
    for v in values:
        if isinstance(v, str):
            v = datetime.datetime.fromisoformat(v)
        if isinstance(v, datetime.datetime):
            v = (v.date() - epoch.date()).days if k is TypeKind.DATE32 \
                else (v - epoch) // datetime.timedelta(microseconds=1)
        elif isinstance(v, datetime.date):
            v = (v - epoch.date()).days if k is TypeKind.DATE32 \
                else (v - epoch.date()).days * 86_400_000_000
        out.append(v)
    return out


def _encode_values(values: list, dtype: DataType, device) -> Column:
    """Host encode of a Python list (numpy), then one copy of each plane to
    `device`. None is NULL."""
    values = _temporal_ints(values, dtype)
    n = len(values)
    cap = padded_capacity(n)
    validity = np.asarray([v is not None for v in values], dtype=bool)
    dictionary = None
    if dtype.is_dictionary:
        dictionary, data = Dictionary.from_values(values)
    elif dtype.kind is TypeKind.BOOLEAN:
        data = np.asarray(
            [bool(v) if v is not None else False for v in values], dtype=bool
        )
    elif dtype.kind is TypeKind.DECIMAL128 and dtype.params:
        scale = dtype.params[1]
        data = np.asarray(
            [int(round(float(v) * 10**scale)) if v is not None else 0
             for v in values],
            dtype=np.int64,
        )
    else:
        data = np.asarray(
            [v if v is not None else 0 for v in values],
            dtype=dtype.device_dtype,
        )
    return Column(
        to_tensor(_pad_1d(data, cap), device),
        to_tensor(_pad_1d(validity, cap, fill=False), device),
        dtype,
        dictionary,
    )


class ColumnBatch:
    """A batch of rows in columnar layout on one torch device."""

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema, columns: List[Column], num_rows: int):
        if len(schema) != len(columns):
            raise SchemaError(
                f"schema has {len(schema)} fields but {len(columns)} columns given"
            )
        caps = {c.capacity for c in columns}
        if len(caps) > 1:
            raise ExecutionError(f"ragged column capacities: {caps}")
        self.schema = schema
        self.columns = columns
        self.num_rows = int(num_rows)

    # ---- properties ----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else padded_capacity(self.num_rows)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: Union[int, str]) -> Column:
        if isinstance(i, str):
            i = self.schema.index_of(i)
        return self.columns[i]

    def live_mask_np(self) -> np.ndarray:
        m = np.zeros(self.capacity, dtype=bool)
        m[: self.num_rows] = True
        return m

    def to(self, device) -> "ColumnBatch":
        """The same batch with every plane on `device` (columns already
        there are shared, not copied)."""
        return ColumnBatch(
            self.schema, [c.to(device) for c in self.columns], self.num_rows
        )

    # ---- constructors --------------------------------------------------
    @staticmethod
    def from_pydict(
        data: Dict[str, Sequence], schema: Optional[Schema] = None,
        device="cpu",
    ) -> "ColumnBatch":
        names = list(data.keys())
        n = len(next(iter(data.values()))) if data else 0
        if schema is None:
            fields = [Field(name, _infer_type(data[name])) for name in names]
            schema = Schema(fields)
        cols = []
        for f in schema:
            vals = list(data[f.name])
            if len(vals) != n:
                raise SchemaError(f"ragged column '{f.name}'")
            cols.append(_encode_values(vals, f.data_type, device))
        return ColumnBatch(schema, cols, n)

    @staticmethod
    def empty(schema: Schema, device="cpu") -> "ColumnBatch":
        cols = []
        for f in schema:
            cap = CAPACITY_MIN
            data = np.zeros(cap, dtype=f.data_type.device_dtype)
            validity = np.zeros(cap, dtype=bool)
            d = Dictionary.empty() if f.data_type.is_dictionary else None
            cols.append(Column(to_tensor(data, device),
                               to_tensor(validity, device), f.data_type, d))
        return ColumnBatch(schema, cols, 0)

    @staticmethod
    def from_arrow(rb, device="cpu") -> "ColumnBatch":
        """Ingest a pyarrow RecordBatch/Table."""
        if pa is None:
            raise ExecutionError("pyarrow unavailable")
        if isinstance(rb, pa.Table):
            rb = rb.combine_chunks()
            arrays = [
                col.chunk(0) if col.num_chunks else pa.array([], type=col.type)
                for col in rb.columns
            ]
            schema_src = rb.schema
            n = rb.num_rows
        else:
            arrays = rb.columns
            schema_src = rb.schema
            n = rb.num_rows
        schema = Schema.from_arrow(schema_src)
        cap = padded_capacity(n)
        cols = []
        for arr, f in zip(arrays, schema):
            validity = np.asarray(arr.is_valid())
            if f.data_type.is_dictionary:
                pylist = arr.to_pylist()
                dictionary, codes = Dictionary.from_values(pylist)
                data = codes
            else:
                np_dtype = f.data_type.device_dtype
                # fill nulls with 0 then cast
                if arr.null_count:
                    import pyarrow.compute as pc

                    arr = pc.fill_null(arr, 0)
                if pa.types.is_timestamp(arr.type) or pa.types.is_duration(arr.type):
                    data = arr.cast(pa.int64()).to_numpy(zero_copy_only=False)
                elif pa.types.is_date32(arr.type):
                    data = arr.cast(pa.int32()).to_numpy(zero_copy_only=False)
                elif pa.types.is_date64(arr.type):
                    data = arr.cast(pa.int64()).to_numpy(zero_copy_only=False)
                elif pa.types.is_decimal(arr.type):
                    scale = arr.type.scale
                    data = np.asarray(
                        [
                            int(round(float(x) * 10**scale)) if x is not None else 0
                            for x in arr.to_pylist()
                        ],
                        dtype=np.int64,
                    )
                else:
                    data = arr.to_numpy(zero_copy_only=False)
                data = np.ascontiguousarray(data).astype(np_dtype, copy=False)
                dictionary = None
            cols.append(
                Column(
                    to_tensor(_pad_1d(np.asarray(data), cap), device),
                    to_tensor(_pad_1d(validity, cap, fill=False), device),
                    f.data_type,
                    dictionary,
                )
            )
        return ColumnBatch(schema, cols, n)

    # ---- exporters -----------------------------------------------------
    def to_pydict(self) -> Dict[str, list]:
        return {f.name: vals
                for f, vals in zip(self.schema, self.host_pylists())}

    def to_pylist(self) -> List[tuple]:
        return list(zip(*self.host_pylists()))

    def host_planes(self) -> List[tuple]:
        """(data, validity) numpy arrays of every column's live rows. The
        planes' bytes are packed into one buffer on their device and read
        to the host in one transfer, not two per column."""
        n = self.num_rows
        planes = [p[:n] for c in self.columns for p in (c.data, c.validity)]
        if not planes:
            return []
        # only a plane that is not dense (a broadcast has stride 0, also
        # where it holds one row), or not on the first plane's device, is
        # copied before the pack
        dev = planes[0].device
        flat = torch.cat([
            (p if p.is_contiguous() and p.stride(-1) == 1
             else p.clone(memory_format=torch.contiguous_format))
            .to(dev).view(torch.uint8).reshape(-1)
            for p in planes]).cpu().numpy()
        arrs, off = [], 0
        for p in planes:
            size = p.numel() * p.element_size()
            dt = torch.empty(0, dtype=p.dtype).numpy().dtype
            arrs.append(flat[off:off + size].view(dt).reshape(p.shape))
            off += size
        return list(zip(arrs[0::2], arrs[1::2]))

    def host_pylists(self) -> List[list]:
        """Every column's live rows as Python values, the same as
        `Column.to_pylist`, from one read of the planes (`host_planes`):
        the one way a batch comes to Python (`to_pylist`, `to_pydict`, the
        pgwire DataRows). Imports no pyarrow: it is `to_arrow`'s host
        step."""
        with span("result"):
            return [host_pylist(d, v, c.dtype, c.dictionary)
                    for (d, v), c in zip(self.host_planes(), self.columns)]

    def to_arrow(self):
        """A pyarrow RecordBatch of the live rows: each plane read to the
        host once (`host_pylists`), then one arrow array per column."""
        if pa is None:
            raise ExecutionError("pyarrow unavailable")
        arrays = [pa.array(vals, type=f.data_type.to_arrow())
                  for vals, f in zip(self.host_pylists(), self.schema)]
        return pa.RecordBatch.from_arrays(arrays,
                                          schema=self.schema.to_arrow())

    # ---- transforms ----------------------------------------------------
    def select(self, indices: Sequence[int]) -> "ColumnBatch":
        return ColumnBatch(
            self.schema.project(indices),
            [self.columns[i] for i in indices],
            self.num_rows,
        )

    def rename(self, names: Sequence[str]) -> "ColumnBatch":
        schema = Schema(
            [f.with_name(n) for f, n in zip(self.schema, names)]
        )
        return ColumnBatch(schema, self.columns, self.num_rows)

    def slice(self, offset: int, length: int) -> "ColumnBatch":
        """Row slice (LIMIT/OFFSET; reference executor.rs:299-341)."""
        offset = min(max(offset, 0), self.num_rows)
        length = min(length, self.num_rows - offset)
        idx = np.arange(offset, offset + length)
        cap = padded_capacity(length)
        cols = [c.take_host(idx, cap) for c in self.columns]
        return ColumnBatch(self.schema, cols, length)

    def take_host(self, indices: np.ndarray) -> "ColumnBatch":
        cap = padded_capacity(len(indices))
        cols = [c.take_host(indices, cap) for c in self.columns]
        return ColumnBatch(self.schema, cols, len(indices))

    def take(self, indices: torch.Tensor, count: int) -> "ColumnBatch":
        """Gather rows by a device index plane whose first `count` slots are
        the rows to keep, into a batch at `padded_capacity(count)`: the
        gather runs on the batch's device, and pad rows hold 0 and are
        invalid, as `take_host` leaves them."""
        cap = padded_capacity(count)
        if not self.columns:
            return ColumnBatch(self.schema, [], count)
        dev = self.columns[0].data.device
        idx = indices.to(device=dev, dtype=torch.int64)[:cap]
        if idx.shape[0] < cap:
            idx = _pad_t(idx, cap)
        live = torch.arange(cap, device=dev) < count
        cols = []
        for c in self.columns:
            zero = torch.zeros((), dtype=c.data.dtype, device=dev)
            cols.append(Column(torch.where(live, c.data[idx], zero),
                               c.validity[idx] & live, c.dtype, c.dictionary))
        return ColumnBatch(self.schema, cols, count)

    @staticmethod
    def concat(batches: List["ColumnBatch"]) -> "ColumnBatch":
        """Concatenate batches of the same schema, merging dictionaries.
        The planes stay on their device; dictionaries merge on the host."""
        batches = [b for b in batches if b is not None]
        if not batches:
            raise ExecutionError("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        schema = batches[0].schema
        total = sum(b.num_rows for b in batches)
        cap = padded_capacity(total)
        cols: List[Column] = []
        for ci, f in enumerate(schema):
            parts_d, parts_v = [], []
            if f.data_type.is_dictionary:
                dicts = [
                    b.columns[ci].dictionary or Dictionary.empty() for b in batches
                ]
                merged, remaps = merge_many(dicts)
                for b, remap in zip(batches, remaps):
                    codes = b.columns[ci].data[: b.num_rows]
                    if len(remap):
                        rt = torch.as_tensor(remap, device=codes.device)
                        codes = rt[codes.long().clamp(0, len(remap) - 1)]
                    parts_d.append(codes)
                    parts_v.append(b.columns[ci].validity[: b.num_rows])
                dictionary = merged
            else:
                for b in batches:
                    parts_d.append(b.columns[ci].data[: b.num_rows])
                    parts_v.append(b.columns[ci].validity[: b.num_rows])
                dictionary = None
            cols.append(
                Column(
                    _pad_t(torch.cat(parts_d), cap),
                    _pad_t(torch.cat(parts_v), cap),
                    f.data_type,
                    dictionary,
                )
            )
        return ColumnBatch(schema, cols, total)

    def __repr__(self) -> str:
        return f"ColumnBatch({self.schema}, rows={self.num_rows}, cap={self.capacity})"
