"""The mesh cases of tests/test_window_rank_dist.py, the port against the
JAX package: PERCENT_RANK, CUME_DIST and NTH_VALUE over a shared PARTITION
BY (one exchange co-locates the partitions), the global (no PARTITION BY)
PERCENT_RANK/CUME_DIST family (range exchange, prior-shard offset,
broadcast total), and RANGE offset frames (partitioned ones per shard,
global ones falling back). Each query through the JAX single-device
Session, the JAX mesh of 8 virtual CPU devices and the port's mesh of 8
CPU shards (tests/torch_mesh_diff.py): the port's rows must equal the JAX
single-device rows and its mesh stats change the JAX mesh's.
"""

import numpy as np
import pytest

from torch_mesh_diff import MeshTrio, check

RNG = np.random.default_rng(31)
N = 1200
K = RNG.integers(0, 9, N)
V = RNG.integers(0, 25, N)  # heavy ties
T = {"id": list(range(N)), "k": [int(x) for x in K], "v": [int(x) for x in V]}


@pytest.fixture(scope="module")
def trio():
    return MeshTrio().register("t", T)


def test_mesh_matches_single_device(trio):
    check(
        trio,
        "SELECT id, PERCENT_RANK() OVER (PARTITION BY k ORDER BY v) AS pr, "
        "CUME_DIST() OVER (PARTITION BY k ORDER BY v) AS cd, "
        "NTH_VALUE(v, 2) OVER (PARTITION BY k ORDER BY v) AS nv "
        "FROM t ORDER BY id",
    )


@pytest.mark.slow
def test_global_rank_dist_lowers_to_mesh():
    fresh = MeshTrio().register("t", T)
    st = check(
        fresh,
        "SELECT id, CUME_DIST() OVER (ORDER BY v) AS cd, "
        "PERCENT_RANK() OVER (ORDER BY v) AS pr FROM t ORDER BY id",
    )
    assert st["fallbacks"] == 0, st
    assert fresh.port.mesh_pipeline.stats["queries"] == 1
    check(
        fresh,
        "SELECT id, NTH_VALUE(v, 3) OVER (ORDER BY v ROWS BETWEEN "
        "UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING) AS nv "
        "FROM t ORDER BY id",
        mesh_used=False,
    )


@pytest.mark.slow
def test_range_offset_frames_mesh():
    data = {"id": list(range(400)),
            "k": [i % 3 for i in range(400)],
            "v": [float((i * 13) % 50) for i in range(400)]}
    fresh = MeshTrio().register("e2", data)
    check(
        fresh,
        "SELECT id, SUM(v) OVER (PARTITION BY k ORDER BY v "
        "RANGE BETWEEN 4 PRECEDING AND 4 FOLLOWING) AS r FROM e2 "
        "ORDER BY id",
    )
    check(
        fresh,
        "SELECT id, SUM(v) OVER (ORDER BY v RANGE BETWEEN 4 PRECEDING "
        "AND 4 FOLLOWING) AS r FROM e2 ORDER BY id",
        mesh_used=False,
    )
