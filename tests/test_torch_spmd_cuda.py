"""The mesh building blocks on the card (`parallel/mesh.py`, `spmd.py`,
`overlap.py`, `dict_merge.py`): a 4-shard virtual mesh on one CUDA device,
held against the same calls on 4 CPU shards. Each test skips without a
CUDA GPU.

This file imports neither jax nor the JAX package. On the card, from the
root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_spmd_cuda.py -m cuda

Integers, per-shard counts and overflow flags equal; floats (AVG's and a
float SUM's partials, summed in fixed point by group_agg on the card)
within rtol 1e-9; group_agg launches for the aggregates and the bucket
sums.
"""

import numpy as np
import pytest
import torch

from query_engine_tpu_torch.columnar.batch import ColumnBatch
from query_engine_tpu_torch.ops import group_agg
from query_engine_tpu_torch.parallel import spmd
from query_engine_tpu_torch.parallel.dict_merge import ingest_sharded_strings
from query_engine_tpu_torch.parallel.mesh import ShardedTable, make_mesh
from query_engine_tpu_torch.parallel.overlap import (
    make_overlapped_exchange_aggregate, make_sequential_exchange_aggregate,
)

pytestmark = pytest.mark.cuda

N_SHARDS = 4
ROWS = 1 << 16
RTOL = 1e-9


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.fixture()
def meshes():
    return make_mesh(["cuda:0"] * N_SHARDS), make_mesh(["cpu"] * N_SHARDS)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 5000, ROWS)
    v = rng.integers(-1000, 1000, ROWS)
    x = np.round(rng.normal(0, 1e4, ROWS), 3)
    return ColumnBatch.from_pydict({
        "k": [None if i % 97 == 0 else int(a) for i, a in enumerate(k)],
        "v": [None if i % 13 == 0 else int(a) for i, a in enumerate(v)],
        "x": x.tolist(),
        "f": rng.integers(0, 3, ROWS).tolist(),
    })


def _same(gpu, cpu, what, live=None):
    g, c = gpu.cpu().numpy(), cpu.numpy()
    assert g.shape == c.shape, what
    if live is not None:
        g, c = g[live], c[live]
    if np.issubdtype(c.dtype, np.floating):
        np.testing.assert_allclose(g, c, rtol=RTOL, err_msg=what)
    else:
        assert np.array_equal(g, c), what


def _live(counts, per):
    m = np.zeros(len(counts) * per, bool)
    for s, c in enumerate(counts):
        m[s * per: s * per + min(int(c), per)] = True
    return m


def test_make_mesh_takes_the_cuda_devices():
    mesh = make_mesh()
    assert mesh.devices == [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
    assert mesh.home.type == "cuda"


@pytest.mark.parametrize("keys,cap", [((0,), None), ((0, 3), 64)])
def test_distributed_aggregate_on_card(meshes, keys, cap):
    batch = _batch()
    aggs = [("count_star", -1), ("sum", 0), ("avg", 1), ("min", 0),
            ("max", 1), ("sum", 1)]
    outs = []
    for mesh in meshes:
        st = ShardedTable(batch.to(mesh.home), mesh)
        args = ([st.datas[i] for i in keys] + [st.valids[i] for i in keys]
                + [st.shard_rows, st.datas[1], st.datas[2], st.valids[1],
                   st.valids[2]])
        group_agg.launches = 0
        outs.append(spmd.make_distributed_aggregate(
            mesh, aggs, 2, n_keys=len(keys), group_capacity=cap)(*args))
        if mesh.home.type == "cuda":
            torch.cuda.synchronize()
            assert group_agg.launches >= 2 * N_SHARDS
    gpu, cpu = outs
    _same(gpu[-1], cpu[-1], "groups per shard")
    per = cpu[0].shape[0] // N_SHARDS
    live = _live(cpu[-1].numpy(), per)
    for i, (g, c) in enumerate(zip(gpu[:-1], cpu[:-1])):
        _same(g, c, f"plane {i}", live)


def test_distributed_join_counts_on_card(meshes):
    batch = _batch(5)
    outs = []
    for mesh in meshes:
        st = ShardedTable(batch.to(mesh.home), mesh)
        for salt in (1, 2):
            outs.append(spmd.make_distributed_join_counts(
                mesh, 1, 1, salt=salt)(
                st.datas[0], st.valids[0], st.shard_rows,
                st.datas[0], st.valids[0], st.shard_rows,
                st.datas[1], st.valids[1], st.datas[2], st.valids[2]))
    for gpu, cpu in zip(outs[:2], outs[2:]):
        for i in (0, 1, 2, -1):
            _same(gpu[i], cpu[i], f"output {i}")
        lper = cpu[3].shape[0] // N_SHARDS
        _same(gpu[3], cpu[3], "per-row counts",
              _live(cpu[1].numpy(), lper))


def test_distributed_sort_on_card(meshes):
    batch = _batch(7)
    outs = []
    for mesh in meshes:
        st = ShardedTable(batch.to(mesh.home), mesh)
        outs.append(spmd.make_distributed_sort(mesh, n_cols=1)(
            st.datas[2], st.valids[2], st.shard_rows, st.datas[0],
            st.valids[0]))
    gpu, cpu = outs
    _same(gpu[-1], cpu[-1], "overflow")
    _same(gpu[-2], cpu[-2], "rows per shard")
    per = cpu[0].shape[0] // N_SHARDS
    live = _live(cpu[-2].numpy(), per)
    for i in range(4):
        _same(gpu[i], cpu[i], f"plane {i}", live)
    keys = gpu[0].cpu().numpy()[live]
    assert np.array_equal(keys, np.sort(batch.columns[2].np_data()[:ROWS]))


def test_overlapped_and_sequential_on_card(meshes):
    rng = np.random.default_rng(9)
    per = ROWS // N_SHARDS
    key = rng.integers(0, 20000, ROWS)
    kv = rng.random(ROWS) > 0.1
    val = rng.integers(-(2 ** 62), 2 ** 62, ROWS)
    rows = np.full(N_SHARDS, per - 5, np.int64)
    outs = []
    for mesh in meshes:
        tin = [torch.as_tensor(a, device=mesh.home) for a in (key, kv, val)]
        group_agg.launches = 0
        ov = make_overlapped_exchange_aggregate(mesh, 4)(*tin, rows)
        exch, agg = make_sequential_exchange_aggregate(mesh)
        seq = agg(*exch(*tin, rows))
        if mesh.home.type == "cuda":
            torch.cuda.synchronize()
            assert group_agg.launches == 5 * N_SHARDS
        outs.append((ov, seq))
    (gov, gseq), (cov, cseq) = outs
    for g, c in zip(gov + gseq, cov + cseq):
        _same(g, c, "bucket sums and counts")
    assert torch.equal(gov[0], gseq[0]) and torch.equal(gov[1], gseq[1])


def test_ingest_sharded_strings_on_card(meshes):
    rng = np.random.default_rng(2)
    pool = np.asarray(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                       "TRUCK"], dtype=object)
    vals = [pool[rng.integers(0, 7, 3000)].tolist() for _ in range(N_SHARDS)]
    gpu, cpu = (ingest_sharded_strings(m, vals, 4096) for m in meshes)
    assert list(gpu[3].values) == list(cpu[3].values) == sorted(pool)
    _same(gpu[0], cpu[0], "codes")
    _same(gpu[1], cpu[1], "validity")
