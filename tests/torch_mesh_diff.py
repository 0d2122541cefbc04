"""Three Sessions over the same tables, for the mesh tests of the port.

`MeshTrio` holds the JAX package's single-device Session, the JAX package's
Session over an 8-device mesh (the conftest's virtual CPU devices) and the
port's Session over 8 CPU shards (`make_mesh(["cpu"] * 8)`). `check` runs a
query through the three: the port's rows must equal the JAX single-device
rows (as the JAX mesh tests hold the JAX mesh to them), and the change in
the port's `mesh_pipeline.stats` over the query must equal the change in
the JAX mesh's over the same query, for every key of MESH_STATS.
"""

import math

import jax
import pytest

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from query_engine_tpu_torch.engine.session import Session
from query_engine_tpu_torch.parallel.mesh import make_mesh

N_SHARDS = 8
# the mesh stats held equal to the reference's, query by query
MESH_STATS = ("compiles", "hits", "fallbacks", "exchanges",
              "overflow_retries", "joins_counted", "eager_leaves",
              "agg_partial_final")


def jax_mesh():
    devs = jax.devices()
    assert len(devs) >= N_SHARDS, "conftest forces an 8-device CPU mesh"
    return jax_make_mesh(devs[:N_SHARDS])


def port_mesh():
    return make_mesh(["cpu"] * N_SHARDS)


def stats_of(session):
    st = session.mesh_pipeline.stats
    return {k: st.get(k, 0) for k in MESH_STATS}


def stats_change(before, after):
    return {k: after[k] - before[k] for k in MESH_STATS}


class MeshTrio:
    def __init__(self, jmesh=None, pmesh=None):
        self.single = JSession()
        self.jdist = JSession(mesh=jmesh or jax_mesh())
        self.port = Session(device="cpu", mesh=pmesh or port_mesh())

    def register(self, name, data):
        for s in (self.single, self.jdist, self.port):
            s.register_table(name, data)
        return self

    def sql(self, text):
        for s in (self.single, self.jdist, self.port):
            s.sql(text)

    def run(self, text):
        """(JAX single rows, JAX mesh rows, port rows, JAX mesh stats
        change, port stats change)."""
        want = self.single.sql(text).to_pylist()
        j0 = stats_of(self.jdist)
        jrows = self.jdist.sql(text).to_pylist()
        jst = stats_change(j0, stats_of(self.jdist))
        p0 = stats_of(self.port)
        prows = self.port.sql(text).to_pylist()
        pst = stats_change(p0, stats_of(self.port))
        return want, jrows, prows, jst, pst


def close(x, y, float_tol):
    if isinstance(x, float) and isinstance(y, float):
        if math.isnan(x) and math.isnan(y):
            return True
        return x == pytest.approx(y, rel=float_tol)
    return x == y


def same_rows(got, want, ordered=True, float_tol=None, sql=""):
    if float_tol is not None:
        assert len(got) == len(want), f"row count mismatch for {sql}"
        for rg, rw in zip(got, want):
            assert len(rg) == len(rw) and all(
                close(a, b, float_tol) for a, b in zip(rg, rw)
            ), f"approx mismatch for {sql}: {rg} vs {rw}"
    elif ordered:
        assert got == want, (
            f"ordered mismatch for {sql}\n{got[:5]}\n{want[:5]}")
    else:
        assert sorted(map(repr, got)) == sorted(map(repr, want)), (
            f"set mismatch for {sql}")


def check(trio, sql, ordered=True, mesh_used=True, float_tol=None):
    """The port's mesh rows against the JAX single-device rows, its stats
    change against the JAX mesh's; returns the port's stats change."""
    want, _, got, jst, pst = trio.run(sql)
    same_rows(got, want, ordered, float_tol, sql)
    assert pst == jst, f"mesh stats differ for {sql}:\nport {pst}\njax  {jst}"
    if mesh_used:
        assert pst["compiles"] + pst["hits"] >= 1, (
            f"mesh path not used for {sql}: {pst}")
    return pst
