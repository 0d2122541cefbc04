"""Multi-process cluster bootstrap over torch.distributed.

The counterpart of `query_engine_tpu.parallel.cluster`, which joins a pod
through `jax.distributed.initialize`. Here `initialize` joins a
`torch.distributed` process group — gloo for CPU shards, NCCL for CUDA
shards — when a coordinator address is given (the argument, or the
COORDINATOR_ADDRESS environment variable with NUM_PROCESSES and
PROCESS_ID); every process runs the same SPMD program over
`global_mesh()`, one shard per rank on that rank's device, and rank 0 is
the controller. Without an address it reports the local topology.

The process's device is kept here for `global_mesh`, beside
torch.distributed's own process-wide state.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch

from query_engine_tpu_torch.core.errors import DistributedError
from query_engine_tpu_torch.parallel.mesh import Mesh, allgather_rows, \
    make_mesh

_device: Optional[torch.device] = None


@dataclass
class HostInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_controller(self) -> bool:
        return self.process_index == 0


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _grouped() -> bool:
    dist = _dist()
    return dist is not None and dist.is_initialized()


def _env_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise DistributedError(f"a coordinator address needs {name} (or the "
                               "argument) too")
    return int(os.environ[name])


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> HostInfo:
    """Join the cluster. `device` is this process's shard device: "cuda"
    (the default; NCCL, one card per rank, `cuda:{rank % cards}`) or
    "cpu" (gloo). Without an address this is a no-op that reports the
    local topology."""
    global _device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DistributedError("initialize(device='cuda'): no CUDA device is "
                               "visible; pass device='cpu' for CPU shards")
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address:
        dist = _dist()
        if dist is None:
            raise DistributedError("torch.distributed is not available")
        world = _env_int("NUM_PROCESSES", num_processes)
        rank = _env_int("PROCESS_ID", process_id)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        url = address if "://" in address else f"tcp://{address}"
        try:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo", init_method=url,
                world_size=world, rank=rank)
        except (RuntimeError, ValueError) as e:
            raise DistributedError(
                f"torch.distributed.init_process_group failed: {e}") from e
    _device = dev
    return host_info()


def host_info() -> HostInfo:
    """This process's place in the cluster (one shard per process when
    grouped; every local card, or the one CPU, when not)."""
    if _grouped():
        dist = _dist()
        world = dist.get_world_size()
        return HostInfo(dist.get_rank(), world, 1, world)
    dev = _device or torch.device("cuda")
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return HostInfo(0, 1, local, local)


def global_mesh(axis: str = "data") -> Mesh:
    """A mesh over the whole cluster: one shard per rank when grouped,
    else every local card (or the one CPU shard initialize was given)."""
    if _grouped():
        return Mesh.over_processes(_device or torch.device("cuda"), axis)
    if _device is not None and _device.type == "cpu":
        return make_mesh([_device], axis)
    return make_mesh(None, axis)


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """This process's sharded output planes concatenated with every other
    process's, in rank order, on every process (`multihost_utils.
    process_allgather(x, tiled=True)`'s counterpart)."""
    return allgather_rows(t)


def shutdown() -> None:
    global _device
    if _grouped():
        _dist().destroy_process_group()
    _device = None
