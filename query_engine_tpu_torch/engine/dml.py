"""The row work of the Session's DML statements, on the table's device.

The JAX Session runs DML over host rows: it reads the table into Python
lists (`to_pydict`), edits them and encodes a new batch from them with
`ColumnBatch.from_pydict(rows, schema)`. The functions here give the batch
that encode would give, computed on the planes where they lie:

* a value becomes the column's type as `_encode_values` makes it: an
  integer column truncates a float toward zero, a DECIMAL(p, s) column
  stores round(float(v) * 10^s) (half to even, as Python's `round`), a
  boolean stores v != 0, and a NULL is invalid with 0 data. `descale` says
  whether the value arrives as `to_pylist` gives it (a DECIMAL divided by
  10^scale: INSERT ... SELECT, UPDATE ... FROM) or as the plane's raw
  `.item()` (the JAX package's UPDATE: a DECIMAL expression arrives scaled
  and is scaled again, ROADMAP §3);
* a string column's dictionary is rebuilt from the values present, with ""
  when a live row is NULL, as `Dictionary.from_values` builds it; codes are
  remapped on the device (`compact_dictionary`), the host reads one flag a
  dictionary value;
* a rebuilt or filtered table has capacity `padded_capacity(num_rows)`; pad
  rows hold 0 and are invalid.

Every result is a new tensor: a stored plane is never written in place, so
a transaction's snapshot, which holds the old batch, stays valid, and so
do the bounds the compiled pipeline caches on a stored `Column`.

`host` is the executor's counted device-to-host read (`_host_list`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.core.types import DataType, TypeKind
from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, _pad_t, padded_capacity,
)
from query_engine_tpu_torch.columnar.dictionary import Dictionary
from query_engine_tpu_torch.engine.expr_eval import Val, _torch_dtype
from query_engine_tpu_torch.ops import kernels as K

_FLOAT_KINDS = (TypeKind.FLOAT32, TypeKind.FLOAT64)


def coerce(v: Val, dtype: DataType, descale: bool, rows=None,
           host=None) -> Val:
    """`v` as a column of type `dtype` stores it (the module's rules).
    `rows` (a device mask) and `host` are needed only for string values
    stored in a non-string column: the rows whose values are stored."""
    if dtype.is_dictionary:
        if v.dictionary is None and v.dtype.kind is not TypeKind.NULL:
            raise TypeError(
                f"cannot store a {v.dtype} value in a {dtype} column")
        d = v.dictionary if v.dictionary is not None else Dictionary.empty()
        return Val(v.data.to(torch.int32), v.validity, dtype, d)
    if v.dictionary is not None:
        return _strings_to(v, dtype, rows, host)
    x = v.data
    if x.dtype == torch.bool:
        x = x.to(torch.int64)
    if descale and v.dtype.kind is TypeKind.DECIMAL128 and v.dtype.params:
        x = x.to(torch.float64) / (10 ** v.dtype.params[1])
    kind = dtype.kind
    if kind is TypeKind.DECIMAL128 and dtype.params:
        out = torch.round(x.to(torch.float64) * (10 ** dtype.params[1])
                          ).to(torch.int64)
    elif kind is TypeKind.BOOLEAN:
        out = x != 0
    elif kind in _FLOAT_KINDS:
        out = x.to(_torch_dtype(dtype))
    else:
        if x.is_floating_point():
            x = torch.trunc(x)
        out = x.to(_torch_dtype(dtype))
    return Val(out, v.validity, dtype, None)


def _strings_to(v: Val, dtype: DataType, rows, host) -> Val:
    """String values stored in a non-string column: each dictionary value
    converted once on the host as numpy converts it ('5' becomes 5), then
    gathered by code on the device. A value numpy rejects ('x') raises its
    ValueError if a stored row holds it: one host read, made only when
    the dictionary has such a value."""

    def convert(x):
        if dtype.kind is TypeKind.DECIMAL128 and dtype.params:
            return int(round(float(x) * 10 ** dtype.params[1]))
        if dtype.kind is TypeKind.BOOLEAN:
            return bool(x)
        return np.asarray([x], dtype=dtype.device_dtype)[0]

    values, bad, error = [], [], None
    for x in v.dictionary.values:
        try:
            values.append(convert(x))
            bad.append(False)
        except (ValueError, TypeError) as e:
            values.append(0)
            bad.append(True)
            error = error or e
    codes = v.data.to(torch.int64).clamp(0, max(len(values) - 1, 0))
    dev = v.data.device
    if error is not None:
        stored = v.validity & rows
        flags = torch.from_numpy(np.asarray(bad)).to(dev)[codes] & stored
        if host(flags.any().reshape(1))[0]:
            raise error
    table = np.asarray(values or [0], dtype=np.dtype(dtype.device_dtype))
    t = torch.from_numpy(table).to(dev).to(_torch_dtype(dtype))
    return Val(t[codes], v.validity, dtype, None)


def compact_dictionary(data: torch.Tensor, valid: torch.Tensor,
                       num_rows: int, dictionary: Dictionary, host
                       ) -> Tuple[torch.Tensor, Dictionary]:
    """The codes and dictionary `Dictionary.from_values` would make from
    the live rows' strings: only the values present, "" (code 0) when a
    live row is NULL; invalid and pad rows hold code 0. One host read of a
    flag per dictionary value. The dictionary object is kept when its
    values do not change."""
    cap = data.shape[0]
    live = torch.arange(cap, device=data.device) < num_rows
    ok = live & valid
    size = len(dictionary)
    codes = data.to(torch.int64).clamp(0, max(size - 1, 0))
    present = torch.zeros(size + 1, dtype=torch.int64, device=data.device)
    present.scatter_add_(0, torch.where(ok, codes, size),
                         torch.ones_like(codes))
    flags = host(torch.cat([present[:size] > 0,
                            (live & ~valid).any().reshape(1)]))
    keep = np.asarray(flags[:size], dtype=bool)
    values = dictionary.values[keep]
    if flags[size] and (len(values) == 0 or values[0] != ""):
        values = np.concatenate([np.asarray([""], dtype=object), values])
    if len(values) == size and keep.all():
        new_dict = dictionary
        new_codes = codes
    else:
        new_dict = Dictionary(values)
        remap = np.searchsorted(values, dictionary.values[keep]) \
            if keep.any() else np.zeros(0, dtype=np.int64)
        table = np.zeros(max(size, 1), dtype=np.int64)
        table[np.nonzero(keep)[0]] = remap
        new_codes = torch.from_numpy(table).to(data.device)[codes]
    return torch.where(ok, new_codes, 0).to(torch.int32), new_dict


def _merge_codes(old: Column, v: Val) -> Tuple[torch.Tensor, torch.Tensor,
                                                Dictionary]:
    """Both sides' codes on their merged (sorted) dictionary."""
    da = old.dictionary or Dictionary.empty()
    db = v.dictionary or Dictionary.empty()
    merged, ra, rb = da.merge(db)

    def remap(codes, table, n):
        if n == 0 or table is None or len(table) == 0:
            return codes.to(torch.int64)
        t = torch.from_numpy(np.asarray(table, dtype=np.int64)).to(
            codes.device)
        return t[codes.to(torch.int64).clamp(0, n - 1)]

    return (remap(old.data, ra, len(da)), remap(v.data, rb, len(db)), merged)


def fit(t: torch.Tensor, cap: int) -> torch.Tensor:
    """A plane cut or zero-padded (False-padded) to `cap` rows."""
    return _pad_t(t[:cap], cap)


def rebuild(batch: ColumnBatch, assigns: Dict[int, Tuple[torch.Tensor, Val,
                                                         bool]],
            host) -> ColumnBatch:
    """The table the JAX package's `from_pydict(data, schema)` makes after
    an UPDATE: column i takes `coerce(val, descale)` where its mask is
    true (`assigns[i] = (mask, val, descale)`) and keeps its value
    elsewhere; every column is encoded anew at padded_capacity(num_rows)."""
    n = batch.num_rows
    cap = padded_capacity(n)
    dev = batch.columns[0].data.device if batch.columns else None
    live = torch.arange(batch.capacity, device=dev) < n
    cols = []
    for i, (f, c) in enumerate(zip(batch.schema, batch.columns)):
        data, valid, dictionary = c.data, c.validity, c.dictionary
        if i in assigns:
            mask, val, descale = assigns[i]
            new = coerce(val, f.data_type, descale, mask & live, host)
            if f.data_type.is_dictionary:
                data, new_codes, dictionary = _merge_codes(c, new)
                data = torch.where(mask, new_codes, data)
            else:
                data = torch.where(mask, new.data.to(data.dtype), data)
            valid = torch.where(mask, new.validity, valid)
        valid = valid & live
        if f.data_type.is_dictionary:
            data, dictionary = compact_dictionary(
                data, valid, n, dictionary or Dictionary.empty(), host)
        else:
            data = torch.where(valid, data, torch.zeros((), dtype=data.dtype,
                                                        device=dev))
        cols.append(Column(fit(data, cap), fit(valid, cap), f.data_type,
                           dictionary))
    return ColumnBatch(batch.schema, cols, n)


def encode_rows(batch: ColumnBatch, host) -> ColumnBatch:
    """The batch `from_pydict(batch.to_pydict(), schema)` makes: every
    string column's dictionary rebuilt from the values present, NULL and
    pad rows 0, capacity padded_capacity(num_rows)."""
    return rebuild(batch, {}, host)


def select_rows(batch: ColumnBatch, mask: torch.Tensor,
                host) -> Tuple[ColumnBatch, int]:
    """(the live rows where `mask` holds, in order, as `take_host` gives
    them; their count). One host read: the count."""
    count = int(host(K.filter_count(mask, batch.num_rows).reshape(1))[0])
    idx = K.compaction_indices(mask, batch.num_rows, padded_capacity(count))
    return batch.take(idx, count), count


def cast_columns(result: ColumnBatch, given: List[Optional[int]], schema,
                 descale: bool, host) -> ColumnBatch:
    """Rows of `result` in the target `schema`: field j takes result column
    given[j] coerced to its type, or NULL where given[j] is None."""
    dev = result.columns[0].data.device if result.columns else None
    cap = result.capacity
    live = torch.arange(cap, device=dev) < result.num_rows
    cols = []
    for f, gi in zip(schema, given):
        if gi is None:
            cols.append(Column(
                torch.zeros(cap, dtype=_torch_dtype(f.data_type), device=dev),
                torch.zeros(cap, dtype=torch.bool, device=dev), f.data_type,
                Dictionary.empty() if f.data_type.is_dictionary else None))
            continue
        c = result.columns[gi]
        v = coerce(Val(c.data, c.validity, result.schema.field(gi).data_type,
                       c.dictionary), f.data_type, descale, live, host)
        cols.append(Column(v.data, v.validity, f.data_type, v.dictionary))
    return ColumnBatch(schema, cols, result.num_rows)


def fill_serial(col: Column, num_rows: int, nxt: int, host
                ) -> Tuple[Column, int]:
    """SERIAL filling as the JAX Session does it row by row: a NULL takes
    the counter and advances it, an explicit value v moves the counter to
    max(counter, v + 1). Vectorized: before row i with c_i NULLs ahead of
    it, the counter is c_i + max(nxt, max over explicit j < i of
    v_j + 1 - c_j). Returns (the filled column, the next counter): one
    host read."""
    data, valid = col.data.to(torch.int64), col.validity
    cap = data.shape[0]
    live = torch.arange(cap, device=data.device) < num_rows
    null = live & ~valid
    c = torch.cumsum(null.to(torch.int64), 0) - null.to(torch.int64)
    floor = torch.where(live & valid, data + 1 - c,
                        torch.full_like(data, nxt))
    best = torch.cummax(floor, 0).values
    # the bound before row i excludes row i's own explicit value
    before = torch.cat([torch.full((1,), nxt, dtype=torch.int64,
                                   device=data.device), best[:-1]])
    before = torch.maximum(before, torch.full_like(before, nxt))
    filled = torch.where(null, c + before, data)
    last = torch.clamp(best.max(), min=nxt)
    counter = int(host((null.sum() + last).reshape(1))[0]) \
        if num_rows else nxt
    out = Column(filled.to(col.data.dtype), valid | null, col.dtype,
                 col.dictionary)
    return out, counter
