"""Capacity-chunked execution: 100M+-row aggregate queries within device
memory.

The compiled pipeline materializes a whole query segment's intermediates
at row capacity. For the dominant analytical shape

    [Limit] [Sort] [Projection/Filter]* Aggregate( row-local subtree
        over ONE big table [+ small build sides] )

the partial/final decomposition (engine/partial_agg.py) bounds that working
set, with row CHUNKS standing in for shards: the big leaf's planes are cut
into fixed-capacity chunks, the partial aggregate runs per chunk through
the normal compiled pipeline, partials concat, and the final combine + the
group-table operators above run at group size.

One program for every chunk. Each chunk's planes are copied into one set
of staging planes of capacity `cc`, allocated once per plane layout and
kept here, so the partial plan's `_Materialized` leaf has the same planes
(and addresses) for every chunk: on CUDA the partial program is captured
once and replayed for each chunk and each later query, where a view per
chunk would capture a graph (with its own memory pool) for every chunk.
When the pipeline releases a graph that reads staging planes, they are
dropped with it (`drop_staging`) and allocated again on next use, where
the partial program captures again.
The copy is `cc` rows of every plane, read once and written once. The last
chunk's row count goes through the program's row-count input; rows past it
are masked, whatever the staging planes hold there.

Peak device memory ≈ resident table + staging + ONE chunk's working set.
Correct for any row-partition of the big table because every admitted
node below the aggregate is row-decomposable: filters/projections are
rowwise, and joins see the full (small) build side in every chunk, with
join types gated so outer rows of the UNCHUNKED side cannot be emitted
once per chunk.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import torch

from query_engine_tpu_torch.columnar.batch import Column, ColumnBatch
from query_engine_tpu_torch.engine.partial_agg import (
    build_partial_final, partial_eligible,
)
from query_engine_tpu_torch.engine.pipeline import ensure_bounds
from query_engine_tpu_torch.plan import logical as lp
from query_engine_tpu_torch.plan import physical as pp


def chunk_engage_rows() -> int:
    """Capacity from which aggregates execute chunked (pow2). The
    reference's default, kept as a memory guard: on a card whose memory
    holds the unchunked working set, a chunked query runs slower than the
    unchunked one (chip_smoke.py phase 13a measures both)."""
    return int(os.environ.get("QE_CHUNK_ENGAGE", 1 << 27))


def chunk_rows() -> int:
    """Chunk capacity (the reference's default, chosen on its TPU; the
    card's figures are chip_smoke.py phase 13's)."""
    return int(os.environ.get("QE_CHUNK_ROWS", 1 << 25))


class ChunkedAggregate:
    def __init__(self, executor):
        self.executor = executor
        # queries and chunks run chunked; the pipeline's captures and
        # replays made by the chunks' partial programs
        self.stats = {"queries": 0, "chunks": 0, "captures": 0,
                      "replays": 0}
        # plane layout -> [(data, validity)] at cc rows, until a graph that
        # reads them is released
        self._staging = {}

    def try_execute(self, plan: pp.PhysicalPlan) -> Optional[ColumnBatch]:
        """Returns the result, or None when the plan shape / size does not
        call for chunking."""
        # path of group-table operators above the aggregate
        path: List[pp.PhysicalPlan] = []
        node = plan
        while isinstance(node, (pp.PLimit, pp.PSort, pp.PProjection,
                                pp.PFilter, pp.PDistinct, pp.PWindow,
                                pp.PSubquery)):
            path.append(node)
            node = node.input
        if not isinstance(node, pp.PHashAggregate) or node.mode != "single":
            return None
        agg = node
        if not partial_eligible(agg):
            return None
        big = self._admit_below(agg.input, big=None)
        if big is None or isinstance(big, bool):
            return None
        batch = self.executor._exec_scan(big)  # planes on the device
        if batch.capacity < chunk_engage_rows():
            return None
        cc = min(chunk_rows(), batch.capacity)

        from query_engine_tpu_torch.engine.executor import _Materialized

        ensure_bounds(batch, self.executor._host_list)
        partial, final, proj = build_partial_final(agg)

        self.stats["queries"] += 1
        pstats = self.executor.pipeline.stats
        captures, replays = pstats["captures"], pstats["replays"]
        partials: List[ColumnBatch] = []
        n = batch.num_rows
        n_chunks = max(1, (batch.capacity + cc - 1) // cc)
        for i in range(n_chunks):
            lo = i * cc
            rows = min(cc, max(n - lo, 0))
            if rows == 0 and i > 0:
                break
            chunk = self.stage_chunk(batch, lo, cc, rows)
            part_plan = _substitute(partial, id(big), _Materialized(chunk))
            partials.append(self.executor.execute(part_plan))
            self.stats["chunks"] += 1
        self.stats["captures"] += pstats["captures"] - captures
        self.stats["replays"] += pstats["replays"] - replays

        combined = ColumnBatch.concat(partials)
        final_plan = _substitute(proj, id(partial), _Materialized(combined))
        out = self.executor.execute(final_plan)

        # the group-table operators above the aggregate
        for upper in reversed(path):
            rebuilt = dataclasses.replace(upper, input=_Materialized(out))
            out = self.executor.execute(rebuilt)
        return out

    def _admit_below(self, node, big):
        """Validate the sub-aggregate tree is row-decomposable and find
        the single big scan. Returns the big PScan, None (reject), or
        False (no big scan in this subtree — a small build side)."""
        if isinstance(node, pp.PScan):
            b = self.executor._exec_scan(node)
            if b.capacity >= chunk_engage_rows():
                return node if big is None else None
            return False
        if isinstance(node, (pp.PFilter, pp.PProjection, pp.PSubquery)):
            return self._admit_below(node.input, big)
        if isinstance(node, pp.PHashJoin):
            lb = self._admit_below(node.left, big)
            rb = self._admit_below(node.right, big)
            if lb is None or rb is None:
                return None
            if lb is False and rb is False:
                return False
            if lb is not False and rb is not False:
                return None  # two big sides: cannot chunk one
            # outer-join gate: the UNCHUNKED side must not be outer —
            # its unmatched rows would be emitted once per chunk
            jt = node.join_type
            if lb is not False:  # big side is LEFT
                if jt in (lp.JoinType.RIGHT, lp.JoinType.FULL,
                          lp.JoinType.CROSS):
                    return None
                return lb
            if jt in (lp.JoinType.LEFT, lp.JoinType.FULL,
                      lp.JoinType.CROSS):
                return None
            return rb
        return None  # sort/distinct/window/setop below the aggregate

    def staging_planes(self, batch: ColumnBatch, cc: int):
        """The staging planes for `batch`'s plane layout at `cc` rows,
        allocated on first use and kept."""
        key = (cc,) + tuple(
            (c.data.dtype, tuple(c.data.shape[1:]), c.data.device)
            for c in batch.columns)
        planes = self._staging.get(key)
        if planes is None:
            planes = [
                (torch.empty((cc,) + tuple(c.data.shape[1:]),
                             dtype=c.data.dtype, device=c.data.device),
                 torch.empty(cc, dtype=torch.bool, device=c.data.device))
                for c in batch.columns
            ]
            self._staging[key] = planes
        return planes

    def drop_staging(self, planes) -> None:
        """Forget the staging planes among `planes` (the input planes of a
        graph the pipeline releases)."""
        ptrs = {t.data_ptr() for pl in planes for dv in pl for t in dv}
        for key in [k for k, st in self._staging.items()
                    if any(d.data_ptr() in ptrs for d, _ in st)]:
            del self._staging[key]

    def stage_chunk(self, batch: ColumnBatch, lo: int, cc: int, rows: int
                    ) -> ColumnBatch:
        """Rows [lo, lo + cc) of `batch` copied into the staging planes, as
        a batch of `rows` live rows at capacity cc."""
        m = min(cc, batch.capacity - lo)
        cols = []
        for c, (d, v) in zip(batch.columns,
                             self.staging_planes(batch, cc)):
            d[:m].copy_(c.data[lo: lo + m])
            v[:m].copy_(c.validity[lo: lo + m])
            nc = Column(d, v, c.dtype, c.dictionary)
            # global stats remain valid covers for any row subset
            b = getattr(c, "_qe_bounds", False)
            if b is not False:
                nc._qe_bounds = b
            md = getattr(c, "_qe_max_dup", None)
            if md is not None:
                nc._qe_max_dup = (rows, md[1])
            cols.append(nc)
        return ColumnBatch(batch.schema, cols, rows)


def _substitute(node, target_id, repl):
    """Copy the plan tree with the node `target_id` replaced."""
    if id(node) == target_id:
        return repl
    changes = {}
    for fname in ("input", "left", "right"):
        child = getattr(node, fname, None)
        if isinstance(child, pp.PhysicalPlan):
            new = _substitute(child, target_id, repl)
            if new is not child:
                changes[fname] = new
    if not changes:
        return node
    return dataclasses.replace(node, **changes)
