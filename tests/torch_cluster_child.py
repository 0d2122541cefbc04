"""Child process for tests/test_torch_cluster.py: joins a 2-process
torch.distributed (gloo) cluster over a local address, runs the port's
SPMD distributed aggregate, sort and join counts across the process
boundary, gathers the sharded outputs to every process, and (on process
0) writes the results as JSON. Imports no JAX.

Run: python tests/torch_cluster_child.py <port> <process_id> <out>
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    port, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]

    from query_engine_tpu_torch.columnar.batch import ColumnBatch
    from query_engine_tpu_torch.parallel import cluster, spmd
    from query_engine_tpu_torch.parallel.mesh import ShardedTable

    info = cluster.initialize(coordinator_address=f"localhost:{port}",
                              num_processes=2, process_id=pid, device="cpu")
    assert info.process_count == 2, info
    assert info.process_index == pid, info
    assert info.global_device_count == 2 and info.local_device_count == 1

    mesh = cluster.global_mesh()
    assert mesh.size == 2 and mesh.local == [pid], mesh
    rng = np.random.default_rng(11)  # identical data on both processes
    n = 4096
    batch = ColumnBatch.from_pydict({
        "k": rng.integers(0, 16, n),
        "v": rng.integers(0, 1000, n),
    })
    st = ShardedTable(batch, mesh)
    assert st.datas[0].shape[0] == st.shard_capacity  # this rank's shard
    agg = spmd.make_distributed_aggregate(
        mesh, aggs=[("count_star", -1), ("sum", 0)], n_args=1,
        group_capacity=64)
    out = agg(st.datas[0], st.valids[0], st.shard_rows, st.datas[1],
              st.valids[1])
    gathered = [cluster.process_allgather(o).numpy() for o in out]
    fkey, fkv = gathered[0], gathered[1]
    cnt, sm, ngs = gathered[2], gathered[4], gathered[-1]
    per = fkey.shape[0] // 2
    results = {}
    for s in range(2):
        for i in range(int(ngs[s])):
            j = s * per + i
            key = int(fkey[j]) if bool(fkv[j]) else None
            assert key not in results, "group split across processes"
            results[str(key)] = [int(cnt[j]), int(sm[j])]

    sort = spmd.make_distributed_sort(mesh, n_cols=1)(
        st.datas[1], st.valids[1], st.shard_rows, st.datas[0], st.valids[0])
    keys = cluster.process_allgather(sort[0]).numpy()
    counts = cluster.process_allgather(sort[-2]).numpy()
    per_s = keys.shape[0] // 2
    ordered = np.concatenate([keys[s * per_s: s * per_s + counts[s]]
                              for s in range(2)])
    overflow = int(cluster.process_allgather(sort[-1]).sum())

    join = spmd.make_distributed_join_counts(mesh, 1, 1)(
        st.datas[0], st.valids[0], st.shard_rows,
        st.datas[0], st.valids[0], st.shard_rows,
        st.datas[1], st.valids[1], st.datas[1], st.valids[1])
    total = int(cluster.process_allgather(join[0]).sum())
    back = st.to_batch().to_pydict()
    if pid == 0:
        with open(out_path, "w") as f:
            json.dump({"groups": results, "sorted": ordered.tolist(),
                       "sort_overflow": overflow, "join_total": total,
                       "roundtrip": back == batch.to_pydict()}, f)
    cluster.shutdown()


if __name__ == "__main__":
    main()
