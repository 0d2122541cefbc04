"""Global dictionary merge for sharded string ingest.

The counterpart of `query_engine_tpu.parallel.dict_merge`. Each shard
ingests its rows independently and builds a local sorted dictionary;
before any cross-shard keyed operator (distributed GROUP BY / ORDER BY /
join on a string column) the codes must agree globally:

  1. every shard's dictionary values travel on the host (they are Python
     strings, never device data);
  2. the controller computes the sorted union (columnar/dictionary.py
     merge_many — order-preserving, so code order is still lexicographic
     order globally);
  3. each shard's old->new remap plane is stacked into one [n_shards, pad]
     plane, and one SPMD program re-encodes every shard's code plane with
     a gather.

After the recode, a distributed GROUP BY or ORDER BY on the string column
is a plain int32 SPMD operator (parallel/spmd.py) and the global
dictionary decodes its results.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from query_engine_tpu_torch.columnar.dictionary import Dictionary, merge_many
from query_engine_tpu_torch.parallel import spmd
from query_engine_tpu_torch.parallel.mesh import Mesh, P


def merge_shard_dictionaries(dicts: Sequence[Dictionary]
                             ) -> Tuple[Dictionary, np.ndarray]:
    """Sorted global union of per-shard dictionaries.

    Returns (global_dict, remap_planes[n_shards, pad]) where
    remap_planes[s, old_code] is shard s's new global code. Rows of the
    plane are padded with 0 (dead codes never gathered by live rows)."""
    merged, remaps = merge_many(list(dicts))
    pad = max([len(r) for r in remaps] + [1])
    planes = np.zeros((len(remaps), pad), dtype=np.int32)
    for s, r in enumerate(remaps):
        planes[s, : len(r)] = r
    return merged, planes


def make_recode(mesh: Mesh, axis: str = "data"):
    """SPMD program: codes[n*cap], remap_planes[n, pad] -> global codes.
    One gather per shard; codes stay int32 planes throughout."""

    def step(codes, remap):
        r = remap[0]  # this shard's [1, pad] slice
        return r[codes.clamp(0, r.shape[0] - 1).to(torch.int64)]

    return spmd.shard_map(step, mesh, (P(axis), P(axis)), P(axis))


def ingest_sharded_strings(mesh: Mesh, per_shard_values: List[Sequence[str]],
                           cap: int, axis: str = "data"
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      np.ndarray, Dictionary]:
    """Sharded string ingest end to end: each shard encodes its own values
    (a dictionary per shard), then the global merge and the recode run.
    Returns (codes[n*cap] globally coded, validity, rows_per_shard,
    global_dict); the planes lie on the mesh's home device and hold this
    process's shards."""
    n = mesh.size
    if len(per_shard_values) != n:
        raise ValueError(f"{len(per_shard_values)} shards of values for a "
                         f"mesh of {n}")
    local_dicts, local_codes, valid = [], [], []
    rows = np.zeros(n, dtype=np.int64)
    for s, vals in enumerate(per_shard_values):
        if len(vals) > cap:
            raise ValueError(f"shard {s}: {len(vals)} values exceed the "
                             f"capacity {cap}")
        d, codes = Dictionary.from_values(vals)
        local_dicts.append(d)
        rows[s] = len(vals)
        c = np.zeros(cap, np.int32)
        c[: len(vals)] = codes
        v = np.zeros(cap, bool)
        v[: len(vals)] = [x is not None for x in vals]
        local_codes.append(c)
        valid.append(v)
    gdict, planes = merge_shard_dictionaries(local_dicts)
    home = mesh.home
    mine = mesh.local
    codes = make_recode(mesh, axis)(
        torch.as_tensor(np.concatenate([local_codes[s] for s in mine]),
                        device=home),
        torch.as_tensor(planes[mine], device=home))
    validity = torch.as_tensor(np.concatenate([valid[s] for s in mine]),
                               device=home)
    return codes, validity, rows, gdict
