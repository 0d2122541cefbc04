"""Device mesh and row-sharded tables.

The counterpart of `query_engine_tpu.parallel.mesh`. There a mesh is a
`jax.sharding.Mesh` over chips and a table's planes are sharded row-wise
along its 'data' axis. Here a `Mesh` is an ordered list of shard slots,
each with the `torch.device` its shard runs on, plus the axis name:

  * a device repeated in the list gives virtual shards on that device
    (`make_mesh(["cuda:0"] * 4)`: four shards on one card;
    `make_mesh(["cpu"] * 8)`: the tests' eight CPU shards), the way the JAX
    tests build eight virtual CPU devices;
  * distinct devices give one shard each (several cards of one host);
  * `Mesh.over_processes` gives one shard per `torch.distributed` rank, on
    that rank's device (parallel/cluster.py).

A sharded plane is one tensor on the mesh's `home` device (the device of
the first shard this process runs) holding this process's shards' blocks
back to back, each `shard_capacity` rows: in one process, every shard, so
the plane read back in shard order equals `np.asarray` of the JAX sharded
array. `spmd.shard_map` hands each shard its block, on its device.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from query_engine_tpu_torch.columnar.batch import (
    Column, ColumnBatch, padded_capacity,
)
from query_engine_tpu_torch.core.errors import DistributedError


class P(tuple):
    """A partition spec, as `jax.sharding.PartitionSpec`: `P(axis)` splits
    dim 0 over the mesh axis, `P()` gives the whole value to every shard."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class Mesh:
    """Shard slots along one axis. `devices[i]` is shard i's device; `local`
    lists the shards this process runs (all of them unless the mesh spans
    processes); `stats` counts shard_map runs, collectives and the bytes
    that collectives moved between shards; `rows_exchanged()` reads the
    live rows that exchanges delivered (`spmd.exchange_columns`), which
    accumulate on the device so a program body reads nothing."""

    def __init__(self, devices: Sequence, axis: str = "data",
                 local: Optional[Sequence[int]] = None,
                 process_group: bool = False):
        if not devices:
            raise DistributedError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis = axis
        self.local: List[int] = (list(range(len(self.devices)))
                                 if local is None else list(local))
        self.process_group = process_group
        self.stats = {"runs": 0, "collectives": 0, "bytes_exchanged": 0}
        self._stats_lock = threading.Lock()
        self._rows = None  # 0-d int64 on `home`: rows exchanges delivered

    @classmethod
    def over_processes(cls, device, axis: str = "data") -> "Mesh":
        """One shard per rank of the initialized process group, this
        process's on `device`. Other ranks' slots name the same device
        type; only this rank's is ever used here."""
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise DistributedError("no torch.distributed process group: "
                                   "call parallel.cluster.initialize first")
        world, rank = dist.get_world_size(), dist.get_rank()
        return cls([device] * world, axis, local=[rank], process_group=True)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[self.local[0]]

    def count(self, key: str, amount: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += amount

    def count_rows(self, rows: torch.Tensor) -> None:
        """Add a 0-d count of rows an exchange delivered (on the device)."""
        rows = rows.to(self.home, torch.int64)
        with self._stats_lock:
            self._rows = rows if self._rows is None else self._rows + rows

    def rows_exchanged(self) -> int:
        """The live rows that exchanges delivered to this process's shards
        since the mesh was made (one host read)."""
        with self._stats_lock:
            return 0 if self._rows is None else int(self._rows.item())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r}"
                f"{', process_group' if self.process_group else ''})")


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data") -> Mesh:
    """A mesh over `devices` (repeat one for virtual shards). With no
    argument, every visible CUDA device; without one it raises."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise DistributedError(
                "make_mesh(): no CUDA device is visible; pass devices "
                "explicitly (make_mesh(['cpu'] * 8) for CPU shards)")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(devices, axis)


def row_sharding(mesh: Mesh, axis: str = "data") -> P:
    return P(axis)


def replicated(mesh: Mesh) -> P:
    return P()


def allgather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order (the
    process group's all_gather; a no-op without one)."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return t
    send = t.contiguous()
    wire = send.to(torch.uint8) if send.dtype == torch.bool else send
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, wire)
    out = torch.cat(parts)
    return out.to(torch.bool) if send.dtype == torch.bool else out


class ShardedTable:
    """A ColumnBatch whose planes are sharded row-wise over the mesh.

    Each shard holds `shard_capacity` = padded_capacity(ceil(rows / n))
    slots, filled front to back (shard i's live count in `shard_rows[i]`,
    a [n] int64 plane given whole to every shard), pad rows zero with
    validity False: the JAX ShardedTable's layout."""

    def __init__(self, batch: ColumnBatch, mesh: Mesh, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        n = mesh.size
        self.schema = batch.schema
        self.dictionaries = [c.dictionary for c in batch.columns]
        total = batch.num_rows
        per = padded_capacity(max((total + n - 1) // n, 1))
        self.shard_capacity = per
        self.num_rows = total
        counts = np.zeros(n, dtype=np.int64)
        used = 0
        for i in range(n):
            counts[i] = min(per, max(total - used, 0))
            used += counts[i]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        home = mesh.home
        self.shard_rows = torch.as_tensor(counts, device=home)
        self.datas: List[torch.Tensor] = []
        self.valids: List[torch.Tensor] = []
        for c in batch.columns:
            data = torch.zeros(len(mesh.local) * per, dtype=c.data.dtype,
                               device=home)
            valid = torch.zeros(len(mesh.local) * per, dtype=torch.bool,
                                device=home)
            for j, i in enumerate(mesh.local):
                k, s = int(counts[i]), int(starts[i])
                data[j * per: j * per + k] = c.data[s: s + k].to(home)
                valid[j * per: j * per + k] = c.validity[s: s + k].to(home)
            self.datas.append(data)
            self.valids.append(valid)

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def to_batch(self) -> ColumnBatch:
        """Gather back to one ColumnBatch on the home device (drops each
        shard's padding); across processes every rank gets every row."""
        n, per = self.n_devices, self.shard_capacity
        counts = self.shard_rows.cpu().numpy()
        keep = np.concatenate(
            [np.arange(i * per, i * per + counts[i]) for i in range(n)])
        idx = torch.as_tensor(keep, dtype=torch.int64, device=self.mesh.home)
        cap = padded_capacity(len(keep))
        cols = []
        for d, v, dic, f in zip(self.datas, self.valids, self.dictionaries,
                                self.schema):
            hd = allgather_rows(d)[idx]
            hv = allgather_rows(v)[idx]
            pad_d = torch.zeros(cap, dtype=hd.dtype, device=hd.device)
            pad_v = torch.zeros(cap, dtype=torch.bool, device=hd.device)
            pad_d[: len(keep)] = hd
            pad_v[: len(keep)] = hv
            cols.append(Column(pad_d, pad_v, f.data_type, dic))
        return ColumnBatch(self.schema, cols, len(keep))
