"""SPMD distributed query kernels: per-shard programs over a mesh.

The counterpart of `query_engine_tpu.parallel.spmd`. Rows live sharded
over a `Mesh` (parallel/mesh.py); the hash shuffle is an all-to-all
between the shards inside one SPMD program, and partial/final
aggregation happens on both sides of it. All shapes are static: each
shard buckets its rows into an [n_shards, per] send buffer, the
all-to-all swaps the leading axis, and local kernels mask by live-row
counts that travel with the data.

`shard_map(f, mesh, in_specs, out_specs)` runs `f` once per shard. In one
process each local shard runs in a host thread of its own, and the
collectives (`axis_index`, `all_to_all`, `all_gather`, `psum`, `pmax`)
meet in lockstep at a barrier: each shard deposits its tensors in a slot,
and after the barrier builds its own result from every slot; a second
barrier keeps a fast shard from overwriting a slot a slow one has not
read. A shard that raises aborts the barrier, so no thread hangs, and the
call re-raises that shard's exception; shards that call different
collectives, or return while another waits in one, raise DistributedError.
On a virtual mesh every shard enqueues on the caller's current stream of
the one device, so the barrier orders each producer before its
consumers; a block that crosses devices is a `.to(device)` copy. On a
process-group mesh (`Mesh.over_processes`) `f` runs this rank's shard
and the collectives are `torch.distributed` calls.

Hashing: torch's uint64 has no right shift on the CPU, and its unsigned
`%` and multiply are no safe basis on CUDA either, so the hash runs in
int64: a multiply wraps in two's complement, bit for bit as in uint64; a
logical right shift is an arithmetic shift masked to 64 - k bits; and the
unsigned `h % n` comes from the 32-bit halves. Partition ids equal the
JAX package's bit for bit.

Grouped counts and sums (the partial and final aggregates, the sort
branch of `bucket_rows`) go through `ops.group_agg`: the group_agg kernel
on the card, its plain version on the CPU.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.ops import kernels as K
from query_engine_tpu_torch.parallel.mesh import Mesh, P

# splitmix64's multipliers as two's-complement int64
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


# ---------------------------------------------------------------------------
# the per-shard runner and its collectives
# ---------------------------------------------------------------------------

_shard = threading.local()


class _Slots:
    """The meeting point of one shard_map run's local shards."""

    def __init__(self, n: int):
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n

    def swap(self, j: int, kind: str, value):
        """Deposit shard j's value; return every local shard's, in order."""
        self.slots[j] = (kind, value)
        self.barrier.wait()
        got = list(self.slots)
        self.barrier.wait()
        kinds = sorted({k for k, _ in got})
        if len(kinds) > 1:
            raise DistributedError(
                f"shards reached different collectives: {kinds}")
        return [v for _, v in got]


class _Shard:
    def __init__(self, mesh: Mesh, j: int, slots: _Slots):
        self.mesh = mesh
        self.j = j                    # position among the local shards
        self.index = mesh.local[j]    # position on the mesh axis
        self.device = mesh.devices[self.index]
        self.slots = slots


def _current(axis: str) -> _Shard:
    s = getattr(_shard, "current", None)
    if s is None:
        raise DistributedError("a collective was called outside shard_map")
    if axis != s.mesh.axis:
        raise DistributedError(f"unknown mesh axis {axis!r} (the mesh's is "
                               f"{s.mesh.axis!r})")
    return s


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as torch.distributed sends it (bool as uint8)."""
    t = t.contiguous()
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bool) if like.dtype == torch.bool else t


def _gather(s: _Shard, kind: str, xs: List[torch.Tensor]) -> list:
    """Every shard's `xs` (one list per shard, in shard order)."""
    got = s.slots.swap(s.j, kind, xs)
    if s.j == 0:
        s.mesh.count("collectives")
    return got


def axis_index(axis: str) -> int:
    """This shard's position on the mesh axis."""
    return _current(axis).index


def all_to_all(x, axis: str, split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = True):
    """Tiled all-to-all along dim 0: each tensor's dim 0 splits into n
    blocks, block d goes to shard d, and shard d receives every shard's
    block d in shard order. `x` is a tensor or a list of tensors (one
    meeting for all of them)."""
    if (split_axis, concat_axis, tiled) != (0, 0, True):
        raise NotImplementedError("all_to_all: only tiled, along dim 0")
    s = _current(axis)
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    n = s.mesh.size
    for t in xs:
        if t.shape[0] % n:
            raise DistributedError(f"all_to_all: dim 0 of {tuple(t.shape)} "
                                   f"does not split over {n} shards")
    if s.mesh.process_group:
        import torch.distributed as dist

        outs = []
        for t in xs:
            w = _wire(t)
            o = torch.empty_like(w)
            dist.all_to_all_single(o, w)
            outs.append(_unwire(o, t))
        s.mesh.count("collectives")
        s.mesh.count("bytes_exchanged",
                      sum(t.numel() * t.element_size() for t in xs)
                      * (n - 1) // n)
    else:
        got = _gather(s, "all_to_all", xs)
        outs, moved = [], 0
        for c, t in enumerate(xs):
            b = t.shape[0] // n
            blocks = []
            for src, theirs in enumerate(got):
                blk = theirs[c][s.index * b: (s.index + 1) * b]
                if src != s.j:
                    moved += blk.numel() * blk.element_size()
                blocks.append(blk.to(s.device))
            outs.append(torch.cat(blocks))
        s.mesh.count("bytes_exchanged", moved)
    return outs[0] if isinstance(x, torch.Tensor) else outs


def all_gather(x: torch.Tensor, axis: str, tiled: bool = False
               ) -> torch.Tensor:
    """Every shard's `x`, stacked on a new dim 0 (concatenated along dim 0
    when tiled), in shard order."""
    s = _current(axis)
    if s.mesh.process_group:
        import torch.distributed as dist

        w = _wire(x)
        parts = [torch.empty_like(w) for _ in range(s.mesh.size)]
        dist.all_gather(parts, w)
        s.mesh.count("collectives")
        parts = [_unwire(p, x) for p in parts]
    else:
        parts = [g[0].to(s.device) for g in _gather(s, "all_gather", [x])]
    return torch.cat(parts) if tiled else torch.stack(parts)


def _reduce(x: torch.Tensor, axis: str, kind: str) -> torch.Tensor:
    s = _current(axis)
    if s.mesh.process_group:
        import torch.distributed as dist

        op = dist.ReduceOp.SUM if kind == "psum" else dist.ReduceOp.MAX
        out = x.clone()
        dist.all_reduce(out, op=op)
        s.mesh.count("collectives")
        return out
    parts = [g[0].to(s.device) for g in _gather(s, kind, [x])]
    out = parts[0]
    for p in parts[1:]:
        out = out + p if kind == "psum" else torch.maximum(out, p)
    return out


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Elementwise sum over the shards (in shard order)."""
    return _reduce(x, axis, "psum")


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Elementwise maximum over the shards."""
    return _reduce(x, axis, "pmax")


def _block(arg, spec, mesh: Mesh, j: int) -> torch.Tensor:
    """Local shard j's part of an argument: its block of dim 0 under
    P(axis), the whole value under P(), on the shard's device."""
    dev = mesh.devices[mesh.local[j]]
    t = arg if isinstance(arg, torch.Tensor) else torch.as_tensor(
        np.asarray(arg))
    if len(spec) == 0:
        return t.to(dev)
    if tuple(spec) != (mesh.axis,):
        raise DistributedError(f"spec {spec!r} does not name the mesh axis "
                               f"{mesh.axis!r}")
    n_local = len(mesh.local)
    if t.shape[0] % n_local:
        raise DistributedError(f"dim 0 of {tuple(t.shape)} does not split "
                               f"over {n_local} shards")
    b = t.shape[0] // n_local
    return t[j * b: (j + 1) * b].to(dev)


@contextlib.contextmanager
def _on_device(dev: torch.device, stream):
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def shard_map(f: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """`f` run once per shard on its blocks of the arguments (see the
    module docstring). Outputs under P(axis) come back concatenated along
    dim 0 in shard order on the mesh's home device; under P(), shard 0's.
    A single spec (not a tuple of them) for out_specs returns one value."""
    in_specs = tuple(in_specs)
    single_out = isinstance(out_specs, P)
    outs_spec = (out_specs,) if single_out else tuple(out_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} arguments, got "
                            f"{len(args)}")
        n_local = len(mesh.local)
        blocks = [[_block(a, sp, mesh, j) for a, sp in zip(args, in_specs)]
                  for j in range(n_local)]
        streams = {}
        for j in range(n_local):
            dev = mesh.devices[mesh.local[j]]
            if dev.type == "cuda" and dev not in streams:
                if torch.cuda.is_current_stream_capturing():
                    raise DistributedError("shard_map does not run inside a "
                                           "CUDA graph capture")
                streams[dev] = torch.cuda.current_stream(dev)
        mesh.count("runs")
        slots = _Slots(n_local)
        results: list = [None] * n_local
        errors: list = []
        lock = threading.Lock()

        def body(j):
            dev = mesh.devices[mesh.local[j]]
            _shard.current = _Shard(mesh, j, slots)
            try:
                with _on_device(dev, streams.get(dev)):
                    out = f(*blocks[j])
                    if not mesh.process_group:
                        slots.swap(j, "return from the shard body", None)
                results[j] = out
            except threading.BrokenBarrierError as e:
                with lock:
                    errors.append((1, e))
            except BaseException as e:  # re-raised by the caller below
                with lock:
                    errors.append((0, e))
                slots.barrier.abort()
            finally:
                _shard.current = None

        if n_local == 1:
            body(0)
        else:
            threads = [threading.Thread(target=body, args=(j,),
                                        name=f"shard-{mesh.local[j]}")
                       for j in range(n_local)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            # the first shard that failed, before the ones its abort woke
            raise min(errors, key=lambda e: e[0])[1]
        per_shard = [r if isinstance(r, (tuple, list)) else (r,)
                     for r in results]
        out = []
        for k, spec in enumerate(outs_spec):
            parts = [r[k] for r in per_shard]
            if len(spec) == 0:
                out.append(parts[0])
                continue
            home = mesh.home
            out.append(torch.cat([p.to(home) for p in parts])
                       if len(parts) > 1 else parts[0])
        return out[0] if single_out else tuple(out)

    return run


# ---------------------------------------------------------------------------
# hashing (splitmix64 finalizer — good avalanche, 64-bit lanes)
# ---------------------------------------------------------------------------


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes (uint64 `x >> k`)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """The splitmix64 finalizer over int64 lanes; the result's bits are
    the uint64 hash's."""
    x = x.to(torch.int64)
    x = (x ^ _srl(x, 30)) * _M1
    x = (x ^ _srl(x, 27)) * _M2
    return x ^ _srl(x, 31)


def umod(h: torch.Tensor, n: int) -> torch.Tensor:
    """`h % n` with h's int64 bits read as uint64, for 0 < n < 2^31: from
    the halves, ((hi % n) * (2^32 % n) + lo % n) % n."""
    hi = _srl(h, 32)
    lo = h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def as_int64(key: torch.Tensor) -> torch.Tensor:
    """A key plane as int64 the way XLA converts it: floats truncate
    toward zero and saturate (NaN to 0), as `.astype(jnp.int64)` does."""
    if not key.is_floating_point():
        return key.to(torch.int64)
    big = key >= 2.0 ** 63
    small = key < -(2.0 ** 63)
    out = torch.where(torch.isnan(key) | big | small,
                      torch.zeros_like(key), key).to(torch.int64)
    out = torch.where(big, torch.full_like(out, _I64_MAX), out)
    return torch.where(small, torch.full_like(out, _I64_MIN), out)


def key_hash(key: torch.Tensor) -> torch.Tensor:
    """splitmix64 of the key's orderable image (floats by value)."""
    return splitmix64(as_int64(K.orderable_i64(key)))


def partition_ids(key: torch.Tensor, valid: torch.Tensor, n_parts: int
                  ) -> torch.Tensor:
    """Row -> partition id by key hash; NULL keys all route to partition 0
    (they form one group / never match in joins, so co-location is all that
    matters). Mirrors reference hash partitioning partition.rs:151-212."""
    pid = umod(key_hash(key), n_parts).to(torch.int32)
    return torch.where(valid, pid, torch.zeros_like(pid))


def combined_partition_ids(keys, valids, n_parts: int) -> torch.Tensor:
    """Partition ids from the combined hash of several key columns (rows
    with any NULL key route to partition 0, like partition_ids)."""
    acc = all_valid = None
    for k, v in zip(keys, valids):
        h = torch.where(v, key_hash(k), torch.zeros((), dtype=torch.int64,
                                                    device=k.device))
        acc = h if acc is None else splitmix64(acc ^ h)
        all_valid = v if all_valid is None else (all_valid & v)
    pid = umod(acc, n_parts).to(torch.int32)
    return torch.where(all_valid, pid, torch.zeros_like(pid))


# ---------------------------------------------------------------------------
# the exchange: bucket locally, all-to-all between the shards
# ---------------------------------------------------------------------------


def bucket_rows(pid: torch.Tensor, live: torch.Tensor, n_parts: int,
                per: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather row indices per destination partition.

    Returns (idx[n_parts, per] local row index planes, int64, and
    counts[n_parts]). Slots beyond a destination's count hold garbage
    indices — consumers mask by `counts` (exchange_columns does). Rows past
    a destination's `per` capacity are dropped (callers count the drop as
    exchange overflow and grow-retry); counts are the rows each
    destination was sent, dropped ones included.

    Up to 32 destinations this is a counting scatter: one 1-D prefix count
    per destination gives each row its rank within its bucket (a cumsum
    along dim 0 of a [rows, n_parts] one-hot, the reference's form, scans
    each column serially on CUDA: seconds at 2^21 rows), and one scatter
    places row indices into their [dest, rank] slot; dead and dropped
    rows write spill slots of their own past the end (no two writes meet),
    cut off after. Above 32 it is a stable sort of row ids by
    destination, with counts from group_agg.
    """
    rows = pid.shape[0]
    device = pid.device
    key = torch.where(live, pid.to(torch.int64),
                      torch.full((), n_parts, dtype=torch.int64,
                                 device=device))
    iota = torch.arange(rows, device=device)
    if n_parts <= 32:
        within = torch.full((rows,), -1, dtype=torch.int64, device=device)
        counts = torch.zeros(n_parts, dtype=torch.int64, device=device)
        for d in range(n_parts):
            hit = key == d
            rank = torch.cumsum(hit, 0)  # inclusive, int64
            within = torch.where(hit, rank - 1, within)
            if rows:
                counts[d] = rank[-1]
        ok = live & (within < per)
        pos = torch.where(ok, key * per + within, n_parts * per + iota)
        flat = torch.zeros(n_parts * per + rows, dtype=torch.int64,
                           device=device)
        flat[pos] = iota
        return flat[: n_parts * per].reshape(n_parts, per), counts
    siota = torch.sort(key, stable=True).indices
    counts = group_agg.grouped_sums_counts_multi(
        [(None, live)], key, n_parts)[0][1]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(per, device=device)
    gpos = (starts[:, None] + slot[None, :]).clamp(0, max(rows - 1, 0))
    return siota[gpos], counts


def exchange_columns(axis: str, idx: torch.Tensor, counts: torch.Tensor,
                     datas: Sequence[torch.Tensor],
                     valids: Sequence[torch.Tensor]):
    """Shuffle rows to their destination shards. Runs inside shard_map.

    Returns (recv_datas [n*per], recv_valids, recv_live [n*per] bool).
    recv_live marks which received slots hold real rows. The counts and
    every plane cross in one all-to-all.
    """
    n, per = idx.shape
    slot = torch.arange(per, device=idx.device)
    send_live = slot[None, :] < counts[:, None]
    sends = [d[idx] for d in datas]
    send_valids = [v[idx] & send_live for v in valids]
    got = all_to_all([counts] + sends + send_valids, axis)
    recv_counts = got[0]
    recv_live = (slot[None, :] < recv_counts.reshape(n, 1)).reshape(-1)
    k = len(sends)
    out_d = [r.reshape(-1) for r in got[1: 1 + k]]
    out_v = [r.reshape(-1) for r in got[1 + k:]]
    return out_d, out_v, recv_live


def compact_received(recv_live: torch.Tensor, datas, valids,
                     out_capacity: int = None):
    """Compact received rows to the front of the local planes (cumsum +
    scatter, not nonzero — K.compaction_indices rationale).

    out_capacity bounds the compacted planes: the receive buffer is
    [n_shards, per] = whole-table worst case, but a balanced exchange
    delivers ~per rows per shard — without the bound every downstream
    local operator runs at whole-table capacity. Rows beyond out_capacity
    are dropped; callers check count <= out_capacity (overflow -> retry
    larger)."""
    cap = recv_live.shape[0]
    count = recv_live.sum(dtype=torch.int64)
    oc = cap if out_capacity is None else min(out_capacity, cap)
    idx = K.compaction_indices(recv_live, recv_live, oc)
    keep = torch.arange(oc, device=recv_live.device) < count
    return [d[idx] for d in datas], [v[idx] & keep for v in valids], count


# ---------------------------------------------------------------------------
# distributed hash aggregate (partial -> shuffle -> final)
# ---------------------------------------------------------------------------

_AGG_PARTIAL = {
    # final-combine function for each aggregate's partial columns
    "count_star": ("sum",),
    "count": ("sum",),
    "sum": ("sum",),
    "min": ("min",),
    "max": ("max",),
    "avg": ("sum", "sum"),  # (sum, count)
}


def _segment_sum(data, valid, gid, n_rows, cap: int):
    """K.segment_aggregate("sum", ...), a float plane's sum as two
    fixed-point words (`group_agg.two_words`, one group_agg call): the
    final combine sums a few partials a group at 4 x the row capacity,
    where one word's quantum, max|x| * 2^-frac_bits of the whole plane,
    is too coarse for a small or cancelling group."""
    if not data.is_floating_point():
        return K.segment_aggregate("sum", data, valid, gid, n_rows, cap)
    ok = K.live_mask(gid.shape[0], n_rows, gid.device) & valid
    hi, lo = group_agg.two_words(data, ok)
    (s_hi, cnt), (s_lo, _) = group_agg.grouped_sums_counts_multi(
        [(hi, ok), (lo, ok)], gid, cap)
    return s_hi + s_lo, cnt > 0


def _segment(func, data, valid, gid, n_rows, cap: int):
    if func == "sum":
        return _segment_sum(data, valid, gid, n_rows, cap)
    return K.segment_aggregate(func, data, valid, gid, n_rows, cap)


def local_partial_aggregate(keys, key_valids, n_rows,
                            aggs: Sequence[Tuple[str, int]],
                            arg_datas: Sequence, arg_valids: Sequence):
    """Per-shard grouped partial aggregation (multi-key).

    aggs: list of (func, arg_index or -1). Returns (group_keys, group_valids,
    partial planes list, num_groups) at local capacity. AVG's partial is
    its (sum, count) pair, the count as float64. A float SUM is two
    fixed-point words on the card (`_segment_sum`).
    """
    cap = keys[0].shape[0]
    gid, ng, rep = K.group_ids(keys, key_valids, n_rows)
    out_key = [k[rep] for k in keys]
    out_kv = [v[rep] for v in key_valids]
    partials = []
    for func, ai in aggs:
        data = arg_datas[ai] if ai >= 0 else None
        valid = arg_valids[ai] if ai >= 0 else None
        if func == "avg":
            s, sv = _segment_sum(data, valid, gid, n_rows, cap)
            c, _ = K.segment_aggregate("count", data, valid, gid, n_rows,
                                       cap)
            partials.append((s, sv))
            partials.append((c.to(torch.float64),
                             torch.ones(cap, dtype=torch.bool,
                                        device=gid.device)))
        else:
            partials.append(_segment(func, data, valid, gid, n_rows, cap))
    return out_key, out_kv, partials, ng


def local_final_aggregate(keys, key_valids, n_rows,
                          combine_funcs: Sequence[str],
                          partial_datas: Sequence, partial_valids: Sequence):
    """Combine partial rows that landed on this shard after the exchange."""
    cap = keys[0].shape[0]
    gid, ng, rep = K.group_ids(keys, key_valids, n_rows)
    out_key = [k[rep] for k in keys]
    out_kv = [v[rep] for v in key_valids]
    outs = [_segment(cf, d, v, gid, n_rows, cap)
            for cf, d, v in zip(combine_funcs, partial_datas, partial_valids)]
    return out_key, out_kv, outs, ng


def make_distributed_aggregate(mesh: Mesh, aggs: Sequence[Tuple[str, int]],
                               n_args: int, axis: str = "data",
                               n_keys: int = 1, group_capacity: int = None):
    """Build the SPMD grouped aggregate: rows sharded on `axis` -> per-group
    results sharded by group-key hash, over n_keys key columns (partition
    id = combined splitmix64 hash).

    group_capacity bounds the per-shard group count AFTER the local partial
    aggregate; groups past it are cut off, with no flag (callers derive it
    from dictionary sizes / key-range stats). It shrinks the exchange from
    [n, row_capacity] to [n, group_capacity]. None keeps the safe
    worst-case bound (every live row its own group).

    Arguments (per call): n_keys key planes, n_keys validity planes, the
    shard row counts, n_args arg planes, n_args validity planes. Outputs:
    group key and validity planes, per combined column (value, valid)
    planes, per-shard group counts — all sharded.
    """
    n = mesh.size
    combine: List[str] = []
    for func, _ in aggs:
        combine.extend(_AGG_PARTIAL[func])

    def step(*flat_in):
        keys = list(flat_in[:n_keys])
        kvs = list(flat_in[n_keys: 2 * n_keys])
        shard_rows = flat_in[2 * n_keys]
        args = flat_in[2 * n_keys + 1:]
        n_rows = shard_rows[axis_index(axis)]
        cap = keys[0].shape[0]
        arg_datas = list(args[:n_args])
        arg_valids = list(args[n_args:])

        # 1) local partial aggregate
        gkeys, gkvs, partials, ng = local_partial_aggregate(
            keys, kvs, n_rows, aggs, arg_datas, arg_valids)
        S = min(group_capacity, cap) if group_capacity else cap
        if S < cap:
            gkeys = [k[:S] for k in gkeys]
            gkvs = [v[:S] for v in gkvs]
            partials = [(p[:S], pv[:S]) for p, pv in partials]
        # 2) shuffle partial groups by combined key hash
        pid = combined_partition_ids(gkeys, gkvs, n)
        live = torch.arange(S, device=pid.device) < ng
        idx, counts = bucket_rows(pid, live, n, S)
        datas = gkeys + [p[0] for p in partials]
        valids = gkvs + [p[1] for p in partials]
        rdatas, rvalids, rlive = exchange_columns(axis, idx, counts, datas,
                                                  valids)
        cdatas, cvalids, ccount = compact_received(rlive, rdatas, rvalids)
        # 3) local final aggregate (received key validity carries null-ness;
        # padding rows are masked by ccount inside the grouping kernels)
        fkeys, fkvs, outs, fng = local_final_aggregate(
            cdatas[:n_keys], cvalids[:n_keys], ccount, combine,
            cdatas[n_keys:], cvalids[n_keys:])
        flat = list(fkeys) + list(fkvs)
        for v, vv in outs:
            flat += [v, vv]
        flat.append(fng.reshape(1))
        return tuple(flat)

    in_specs = tuple([P(axis)] * (2 * n_keys) + [P()]
                     + [P(axis)] * (2 * n_args))
    n_out = 2 * n_keys + 2 * len(combine) + 1
    return shard_map(step, mesh, in_specs, tuple([P(axis)] * n_out))


# ---------------------------------------------------------------------------
# distributed hash join (repartition both sides -> local join counts)
# ---------------------------------------------------------------------------


def _cap128(x: int) -> int:
    """Capacity rounding in multiples of 128 — not pow2 buckets: pow2
    rounding of a 1.25x-slack capacity costs up to 2x local work."""
    return max(128, ((int(x) + 127) // 128) * 128)


def send_cap(per_shard: int, n: int, factor) -> int:
    """Per-destination send-buffer capacity: the balanced share x factor.
    factor=None keeps the whole-table worst case."""
    if factor is None:
        return per_shard
    want = int(np.ceil(per_shard / n * factor))
    return min(_cap128(want), per_shard)


DEFAULT_RECV_FACTOR = 1.125  # bounded exchanges are the default; overflow
# flags + the caller's grow-and-retry handle skew. Every point of receive
# capacity is a point of local work downstream (the received planes feed
# full-capacity sorts and scans), and splitmix64's balance at mesh sizes is
# sub-percent for non-degenerate keys.


def make_distributed_join_counts(mesh: Mesh, n_left_cols: int,
                                 n_right_cols: int, axis: str = "data",
                                 salt: int = 1,
                                 recv_factor: float = DEFAULT_RECV_FACTOR):
    """Build the SPMD 'repartition + local join count' program.

    Returns per shard: the exchanged left/right planes (compacted) and the
    local match counts — the host then sizes emit buffers per shard
    (count-then-emit across the mesh).

    Skew: with salt > 1 each probe (left) row routes to one of `salt`
    consecutive partitions of its key hash, and every build (right) row is
    replicated to all `salt` of them, so a hot key spreads over `salt`
    shards. salt=1 is the plain hash shuffle.

    Exchanges are bounded by default (recv_factor): the send planes
    (balanced share x factor per destination) and the compacted receive
    planes. Skew beyond the bound trips the trailing overflow output — the
    caller retries with a larger factor (or salts). recv_factor=None is
    the always-correct whole-table worst case.

    Arguments: left key, its validity, left shard rows, right key, its
    validity, right shard rows, then the left columns, their validities,
    the right columns, their validities. Outputs: total, left count, right
    count, per-left-row counts, left ranks, rank_start, right_by_rank, the
    compacted left planes (key first) and validities, the right ones, and
    the overflow count.
    """
    n = mesh.size
    salt = max(1, min(salt, n))

    def _rcap(per_shard: int, mult: int = 1) -> int:
        """Compacted receive capacity: balanced share x factor."""
        if recv_factor is None:
            return per_shard * mult * n
        want = int(per_shard * mult * recv_factor)
        return min(_cap128(want), per_shard * mult * n)

    def step(lkey, lkv, l_rows, rkey, rkv, r_rows, *cols):
        my = axis_index(axis)
        nl, nr = l_rows[my], r_rows[my]
        lcap, rcap = lkey.shape[0], rkey.shape[0]
        dev = lkey.device
        ldatas = list(cols[:n_left_cols])
        lvalids = list(cols[n_left_cols: 2 * n_left_cols])
        rdatas = list(cols[2 * n_left_cols: 2 * n_left_cols + n_right_cols])
        rvalids = list(cols[2 * n_left_cols + n_right_cols:])

        # repartition left by key hash (+ per-row salt when salt > 1)
        lpid = partition_ids(lkey, lkv, n)
        if salt > 1:
            row_salt = torch.arange(lcap, dtype=torch.int32, device=dev) % salt
            lpid = (lpid + row_salt) % n
        llive = torch.arange(lcap, device=dev) < nl
        sc_l = send_cap(lcap, n, recv_factor)
        lidx, lcounts = bucket_rows(lpid, llive, n, sc_l)
        send_drop_l = (lcounts - sc_l).clamp(min=0).sum()
        ld, lv, llive_r = exchange_columns(axis, lidx, lcounts,
                                           [lkey] + ldatas, [lkv] + lvalids)
        lcd, lcv, lcount = compact_received(llive_r, ld, lv, _rcap(lcap))
        # repartition right; with salting the build side is replicated to
        # every salted partition of its key
        if salt > 1:
            rkey_r, rkv_r = rkey.repeat(salt), rkv.repeat(salt)
            rdatas_r = [d.repeat(salt) for d in rdatas]
            rvalids_r = [v.repeat(salt) for v in rvalids]
            s_of = torch.repeat_interleave(
                torch.arange(salt, dtype=torch.int32, device=dev), rcap)
            rpid = (partition_ids(rkey_r, rkv_r, n) + s_of) % n
            rlive = (torch.arange(rcap, device=dev) < nr).repeat(salt)
            rcap_eff = rcap * salt
        else:
            rkey_r, rkv_r = rkey, rkv
            rdatas_r, rvalids_r = rdatas, rvalids
            rpid = partition_ids(rkey, rkv, n)
            rlive = torch.arange(rcap, device=dev) < nr
            rcap_eff = rcap
        sc_r = send_cap(rcap_eff, n, recv_factor)
        ridx, rcounts = bucket_rows(rpid, rlive, n, sc_r)
        send_drop_r = (rcounts - sc_r).clamp(min=0).sum()
        rd, rv, rlive_r = exchange_columns(axis, ridx, rcounts,
                                           [rkey_r] + rdatas_r,
                                           [rkv_r] + rvalids_r)
        rcd, rcv, rcount = compact_received(rlive_r, rd, rv,
                                            _rcap(rcap, salt))

        # local join ranks + counts
        lr, rr = K.join_ranks([(lcd[0], lcv[0])], [(rcd[0], rcv[0])],
                              lcount, rcount)
        (total, counts, _offsets, rank_start, right_by_rank,
         _lm, _rm) = K.join_counts(lr, rr, lcount, rcount)
        overflow = ((lcount > _rcap(lcap)).to(torch.int64)
                    + (rcount > _rcap(rcap, salt)).to(torch.int64)
                    + send_drop_l + send_drop_r)
        out = [total.reshape(1), lcount.reshape(1), rcount.reshape(1)]
        out += [counts, lr, rank_start, right_by_rank]
        out += lcd + lcv + rcd + rcv
        out.append(overflow.reshape(1))  # capacity overflow: retry bigger
        return tuple(out)

    n_cols = 2 * (n_left_cols + n_right_cols)
    in_specs = tuple([P(axis), P(axis), P(), P(axis), P(axis), P()]
                     + [P(axis)] * n_cols)
    n_out = 3 + 4 + (n_left_cols + 1 + n_right_cols + 1) * 2 + 1
    return shard_map(step, mesh, in_specs, tuple([P(axis)] * n_out))


# ---------------------------------------------------------------------------
# distributed sort (sampled range partition -> local sort)
# ---------------------------------------------------------------------------


def sort_samples_for(n: int, cap: int) -> int:
    """Samples per shard for the range-exchange splitter pass: 1024*n
    (capped at the shard capacity), so the relative shard-size error
    2.5*sqrt(n/s) stays ~8% for every mesh size (a shard's received
    fraction is the gap between two adjacent sample quantiles of s*n
    draws; its sd relative to the 1/n mean width is ~sqrt(n/(2s)))."""
    return min(cap, 1024 * max(n, 1))


def sort_recv_factor(n: int, n_samples: int) -> float:
    """Default receive-capacity factor for the sampled range exchange:
    1 + 2.5*sqrt(n/s) concentration slack (~5 sd of the shard-width
    error). Never looser than DEFAULT_RECV_FACTOR; the grow-and-retry
    path covers pathological distributions (one value spanning a shard)."""
    return min(DEFAULT_RECV_FACTOR,
               1.0 + 2.5 * float(np.sqrt(max(n, 1) / n_samples)))


def linspace01(num: int, device) -> torch.Tensor:
    """float64 `jnp.linspace(0.0, 1.0, num)` bit for bit: i * (1 / (num -
    1)) for i < num - 1, then exactly 1.0. JAX computes start * (1 - step)
    + stop * step with step = iota / div, and XLA turns the division by a
    constant into a product with its reciprocal; i / (num - 1) and
    torch.linspace each differ from that in the last ulp at some
    positions, which moves a truncated sample position."""
    if num <= 1:
        return torch.zeros(max(num, 0), dtype=torch.float64, device=device)
    div = num - 1
    step = torch.arange(div, dtype=torch.float64, device=device) * (1.0 / div)
    return torch.cat([step, torch.ones(1, dtype=torch.float64,
                                       device=device)])


def make_distributed_sort(mesh: Mesh, n_cols: int, n_samples: int = None,
                          axis: str = "data", recv_factor="auto"):
    """Build the SPMD global sort: after it runs, shard i holds keys <=
    shard i+1's keys and each shard is locally sorted — the concatenation
    in shard order is the global ORDER BY.

    Splitter pass: stride-sample the unsorted live keys (a systematic
    sample ~ a random one), all_gather the s*n samples, sort that small
    plane and take n-1 evenly spaced pivots. recv_factor: "auto" =
    sort_recv_factor(n, s); a float = that factor (the grow-retry path
    passes doubled floats); None = the whole-table worst case.

    Arguments: key, its validity, the shard rows, n_cols columns and
    their validities. Outputs: the sorted key and columns, their
    validities, the per-shard counts and the overflow count.
    """
    n = mesh.size
    if n_samples is None:
        n_samples = 1024 * n  # keeps the relative width error ~8% at any n
    if recv_factor == "auto":
        recv_factor = sort_recv_factor(n, n_samples)

    def step(key, kv, shard_rows, *cols):
        n_rows = shard_rows[axis_index(axis)]
        cap = key.shape[0]
        dev = key.device
        datas = list(cols[:n_cols])
        valids = list(cols[n_cols:])
        okey = K.orderable_i64(key)
        live = torch.arange(cap, device=dev) < n_rows
        # nulls sort last: +inf surrogate (jnp.where's promotion)
        if okey.is_floating_point():
            skey = torch.where(live & kv, okey.to(torch.float64),
                               float(_I64_MAX))
        else:
            skey = torch.where(live & kv, okey.to(torch.int64), _I64_MAX)
        # stride sample of the live prefix
        span = (n_rows - 1).clamp(min=0).to(torch.float64)
        qpos = (linspace01(n_samples, dev) * span).to(torch.int64)
        samples = skey[qpos]
        all_samples = all_gather(samples, axis).reshape(-1)
        all_sorted = torch.sort(all_samples).values
        # n-1 boundary pivots
        bidx = torch.arange(1, n, device=dev) * (all_sorted.shape[0] // n)
        pivots = all_sorted[bidx].contiguous()
        pid = torch.searchsorted(pivots, skey.contiguous(),
                                 right=True).to(torch.int32)
        sc = send_cap(cap, n, recv_factor)
        idx, counts = bucket_rows(pid, live, n, sc)
        send_drop = (counts - sc).clamp(min=0).sum()
        rd, rv, rlive = exchange_columns(axis, idx, counts, [key] + datas,
                                         [kv] + valids)
        if recv_factor is None:
            oc = cap * n
        else:
            oc = min(_cap128(int(cap * recv_factor)), cap * n)
        cd, cv, ccount = compact_received(rlive, rd, rv, oc)
        # local sort of received rows
        perm = K.sort_permutation([cd[0]], [cv[0]], [True], [False], ccount)
        out = [d[perm] for d in cd] + [v[perm] for v in cv]
        out.append(ccount.reshape(1))
        overflow = (ccount > oc).to(torch.int64) + send_drop
        out.append(overflow.reshape(1))  # capacity overflow: retry bigger
        return tuple(out)

    in_specs = tuple([P(axis), P(axis), P()] + [P(axis)] * (2 * n_cols))
    n_out = (n_cols + 1) * 2 + 2
    return shard_map(step, mesh, in_specs, tuple([P(axis)] * n_out))
