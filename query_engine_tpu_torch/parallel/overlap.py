"""Shuffle/compute overlap: a chunked exchange-then-aggregate.

The counterpart of `query_engine_tpu.parallel.overlap`. The reference
walks distributed stages strictly in order — every Exchange completes
before the next stage's operators start. Here rows are split into C
chunks inside one SPMD program, and chunk k+1's exchange is issued before
chunk k's aggregate, so the two have no data dependence on each other;
one program runs instead of two, and each chunk's exchanged planes are a
C-th of the whole exchange's.

`make_sequential_exchange_aggregate` is the baseline: one program that
exchanges every row, then one that aggregates the exchanged planes.

Each chunk's bucket sums and counts are one group_agg call (the kernel on
the card, its plain version on the CPU): a dead or foreign row maps to
the slot `BUCKET_CAP`, outside the buckets, and is dropped; int64 sums
wrap mod 2^64.
"""

from __future__ import annotations

import torch

from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.parallel import spmd
from query_engine_tpu_torch.parallel.mesh import Mesh, P

BUCKET_CAP = 1 << 12  # per-shard key-space slice (static)


def _bucket_sums(rkey, rval, rkv, rlive, n: int):
    """Per-bucket SUM and COUNT of the received rows: key -> slot
    (key // n) % BUCKET_CAP of this shard's slice."""
    ok = rlive & rkv
    slot = torch.where(
        ok, torch.remainder(torch.div(rkey.to(torch.int64), n,
                                      rounding_mode="floor"), BUCKET_CAP),
        BUCKET_CAP)
    sums, cnts = group_agg.grouped_sum_count(rval.to(torch.int64), ok, slot,
                                             BUCKET_CAP)
    return sums, cnts.to(torch.int32)


def make_overlapped_exchange_aggregate(mesh: Mesh, n_chunks: int = 4,
                                       axis: str = "data"):
    """Hash-repartition + grouped SUM/COUNT over `n_chunks` row chunks.

    Per chunk: rows route to their key's owner shard through the
    all-to-all, and the owner adds SUM/COUNT per key bucket. The loop is
    unrolled so that chunk k+1's exchange is issued before chunk k's
    aggregate.

    Arguments (per shard): key[cap] int, kv[cap] bool, val[cap] int64, and
    the shard row counts (whole). Outputs: per-shard bucket sums (int64)
    and counts (int32), BUCKET_CAP each.
    """
    n = mesh.size

    def step(key, kv, val, shard_rows):
        cap = key.shape[0]
        dev = key.device
        n_rows = shard_rows[spmd.axis_index(axis)]
        chunk = cap // n_chunks
        sums = torch.zeros(BUCKET_CAP, dtype=torch.int64, device=dev)
        cnts = torch.zeros(BUCKET_CAP, dtype=torch.int32, device=dev)

        def exchange(k0):
            ck, cv, cx = (t[k0: k0 + chunk] for t in (key, kv, val))
            live = (torch.arange(chunk, device=dev) + k0) < n_rows
            pid = spmd.partition_ids(ck, cv, n)
            idx, counts = spmd.bucket_rows(pid, live, n, chunk)
            ones = torch.ones(chunk, dtype=torch.bool, device=dev)
            return spmd.exchange_columns(axis, idx, counts, [ck, cx],
                                         [cv, ones])

        def consume(sums, cnts, rd, rv, rlive):
            s, c = _bucket_sums(rd[0], rd[1], rv[0], rlive, n)
            return sums + s, cnts + c

        # chunk k+1's exchange is issued before chunk k is consumed
        pending = exchange(0)
        for c in range(1, n_chunks):
            nxt = exchange(c * chunk)
            sums, cnts = consume(sums, cnts, *pending)
            pending = nxt
        return consume(sums, cnts, *pending)

    return spmd.shard_map(step, mesh, (P(axis), P(axis), P(axis), P()),
                          (P(axis), P(axis)))


def make_sequential_exchange_aggregate(mesh: Mesh, axis: str = "data"):
    """The un-overlapped baseline: one program that exchanges all rows,
    then one that aggregates the exchanged planes — a host barrier between
    the phases, like the reference's stage walk. Returns (exchange,
    aggregate)."""
    n = mesh.size

    def exch(key, kv, val, shard_rows):
        cap = key.shape[0]
        dev = key.device
        live = torch.arange(cap, device=dev) < shard_rows[
            spmd.axis_index(axis)]
        pid = spmd.partition_ids(key, kv, n)
        idx, counts = spmd.bucket_rows(pid, live, n, cap)
        ones = torch.ones(cap, dtype=torch.bool, device=dev)
        rd, rv, rlive = spmd.exchange_columns(axis, idx, counts, [key, val],
                                              [kv, ones])
        return rd[0], rd[1], rv[0], rlive

    def agg(rkey, rval, rkv, rlive):
        return _bucket_sums(rkey, rval, rkv, rlive, n)

    exch_p = spmd.shard_map(exch, mesh, (P(axis), P(axis), P(axis), P()),
                            (P(axis), P(axis), P(axis), P(axis)))
    agg_p = spmd.shard_map(agg, mesh, (P(axis), P(axis), P(axis), P(axis)),
                           (P(axis), P(axis)))
    return exch_p, agg_p
