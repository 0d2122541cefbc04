"""Key hashing for the distributed executor's partitioning.

The reference module (the JAX package's parallel/spmd.py) also holds the
mesh programs: bucketing, the all-to-all exchange, the distributed
aggregates, joins and sorts. Only its host-reachable part is here:
`splitmix64` and `partition_ids`, which the host stage walk's hash
partitioning (parallel/partition.py) uses.

torch's uint64 has no right shift on the CPU, and its unsigned `%` and
multiply are no safe basis on CUDA either, so the hash runs in int64: a
multiply wraps in two's complement, bit for bit as in uint64; a logical
right shift is an arithmetic shift masked to 64 - k bits; and the unsigned
`h % n` comes from the 32-bit halves. Partition ids equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import torch

from query_engine_tpu_torch.ops import kernels as K

# splitmix64's multipliers as two's-complement int64
_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_M2 = 0x94D049BB133111EB - (1 << 64)
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


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
