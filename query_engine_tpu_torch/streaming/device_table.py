"""Device-resident streaming append buffer.

The counterpart of `query_engine_tpu.streaming.device_table`: the stream's
rows stay in torch planes on the table's device. Each incoming batch is
written once into capacity-doubling planes at the append offset, string
columns delta-merge their dictionaries (sorted union on the host, recode of
the resident codes on the device), and a window's snapshot is a view of the
planes. Per-window host->device traffic is O(incoming batch), not
O(buffer).

Writes and snapshots. An append copies the batch into the planes in place
(`plane[off:off + cap].copy_()`), so the planes keep their addresses from
window to window and a window's captured program replays without a new
capture. A snapshot holds the planes and its row count, and appends write
only at or past the table's row count, so a snapshot's first `num_rows`
rows, their validity and their strings keep their values through later
appends, growth (new planes, the old ones left as they were) and
dictionary merges (the recode writes a new plane and a new Dictionary,
never the old ones). `clear()` keeps the planes and their old rows (a
tumbling window's reset); the next append then writes over rows [0, k) of
every earlier snapshot of the same planes. A snapshot is therefore valid
until the first append after a `clear()`: `StreamingQuery` runs the
window's query before that and copies any result plane that shares the
table's storage, so emitted results never change.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity, to_tensor,
)
from query_engine_tpu_torch.core.schema import Schema


def _remap_codes(plane: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """remap[plane] into a new plane (codes clipped into the remap)."""
    return remap[plane.long().clamp(0, remap.shape[0] - 1)]


class DeviceStreamTable:
    """Append-only (with clear/retain) device table for one stream."""

    def __init__(self, schema: Schema, initial_capacity: int = 1024,
                 device="cuda"):
        self.schema = schema
        self.device = torch.device(device)
        self.capacity = padded_capacity(initial_capacity)
        self.num_rows = 0
        self.datas: List[torch.Tensor] = []
        self.valids: List[torch.Tensor] = []
        self.dicts: List[Optional[object]] = []
        for f in schema:
            self.datas.append(to_tensor(
                np.zeros(self.capacity, dtype=f.data_type.device_dtype),
                self.device))
            self.valids.append(torch.zeros(self.capacity, dtype=torch.bool,
                                           device=self.device))
            self.dicts.append(None)  # adopt the first batch's dictionary
        # instrumentation: rows/bytes that crossed host->device, appends
        self.upload_rows = 0
        self.upload_bytes = 0
        self.appends = 0
        self.dict_merges = 0

    @property
    def nbytes(self) -> int:
        """Bytes the table's planes hold on the device."""
        return sum(t.nbytes for t in self.datas + self.valids)

    # ---- growth ---------------------------------------------------------
    def _ensure(self, need_rows: int) -> None:
        if need_rows <= self.capacity:
            return
        new_cap = padded_capacity(need_rows)
        grown_d, grown_v = [], []
        for d, v in zip(self.datas, self.valids):
            nd = torch.zeros(new_cap, dtype=d.dtype, device=d.device)
            nv = torch.zeros(new_cap, dtype=torch.bool, device=v.device)
            nd[: self.capacity] = d
            nv[: self.capacity] = v
            grown_d.append(nd)
            grown_v.append(nv)
        self.datas, self.valids = grown_d, grown_v
        self.capacity = new_cap

    # ---- append ---------------------------------------------------------
    def append(self, batch: ColumnBatch) -> None:
        if list(batch.schema.names()) != list(self.schema.names()):
            raise ValueError(
                f"stream batch schema {batch.schema.names()} != "
                f"{self.schema.names()}"
            )
        k = batch.num_rows
        if k == 0:
            return
        bcap = batch.capacity
        self._ensure(self.num_rows + bcap)
        off = self.num_rows
        for i, c in enumerate(batch.columns):
            d = c.data.to(self.device)
            v = c.validity.to(self.device)
            if c.dictionary is not None:
                inc_remap = self._merge_dict(i, c)
                if inc_remap is not None:
                    d = _remap_codes(d, inc_remap)
            self.upload_bytes += d.nbytes + v.nbytes
            self.datas[i][off:off + bcap].copy_(d)
            self.valids[i][off:off + bcap].copy_(v)
        self.num_rows += k
        self.upload_rows += k
        self.appends += 1

    def _merge_dict(self, i: int, col: Column) -> Optional[torch.Tensor]:
        """Delta-merge the column's dictionary into the table's. Returns the
        remap for the incoming codes, or None. Resident codes are recoded on
        the device into a new plane when the union reorders them."""
        cur = self.dicts[i]
        if cur is None or len(cur) == 0:
            self.dicts[i] = col.dictionary
            return None
        if cur is col.dictionary:
            return None
        merged, self_remap, other_remap = cur.merge(col.dictionary)
        self.dicts[i] = merged
        if not np.array_equal(self_remap, np.arange(len(cur))):
            self.dict_merges += 1
            self.datas[i] = _remap_codes(
                self.datas[i], to_tensor(self_remap.astype(np.int32),
                                         self.device))
        if np.array_equal(other_remap, np.arange(len(col.dictionary))):
            return None
        return to_tensor(other_remap.astype(np.int32), self.device)

    # ---- window lifecycle -----------------------------------------------
    def clear(self) -> None:
        """Tumbling-window reset: planes stay allocated, rows and all."""
        self.num_rows = 0

    def retain_last(self, rows: int) -> None:
        """Sliding-window retention: keep the trailing `rows` rows, in new
        planes."""
        rows = min(rows, self.num_rows)
        if rows == self.num_rows:
            return
        start = self.num_rows - rows
        for i in range(len(self.datas)):
            for planes in (self.datas, self.valids):
                kept = torch.zeros_like(planes[i])
                kept[:rows] = planes[i][start:start + rows]
                planes[i] = kept
        self.num_rows = rows

    def snapshot(self) -> ColumnBatch:
        """The current window over the planes, without a copy: new Column
        objects (no cached statistics) over the current planes and
        dictionaries."""
        cols = [
            Column(d, v, f.data_type, dic)
            for d, v, f, dic in zip(
                self.datas, self.valids, self.schema, self.dicts
            )
        ]
        return ColumnBatch(self.schema, cols, self.num_rows)
