"""Statement-by-statement differential of the port's Session against the
JAX package's, for the DDL, DML, transaction, index and cache tests
(tests/test_torch_ddl.py, test_torch_dml.py, test_torch_transactions.py,
test_torch_index.py, test_torch_cache.py).

A script is a list of statements (or (statement, params) pairs) run in
order through both Sessions; after each, the status or rows (in order) and
the column names must be equal, or both must raise an error of the same
type name. Integers, strings and dates compare exactly, floats to rtol
1e-9. The port runs in one of three modes: compiled, with QE_COMPILED=0
(the eager executor), and admitting nodes as on CUDA (`graphs`: the
pipeline's `_graphs` set and `_capture` stubbed).
"""

import math

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu_torch.engine.session import Session

MODES = ["compiled", "QE_COMPILED=0", "graphs"]
RTOL = 1e-9


def port_session(mode, **kwargs):
    s = Session(device="cpu", **kwargs)
    s.executor._compiled = mode != "QE_COMPILED=0"
    if mode == "graphs":
        s.executor.pipeline._graphs = True
        s.executor.pipeline._capture = lambda *args: None
    return s


def outcome(sess, stmt, params=None):
    """("ok", column names, rows) or ("error", exception type name)."""
    try:
        b = sess.sql(stmt, params) if params is not None else sess.sql(stmt)
        return ("ok", b.schema.names(), b.to_pylist())
    except Exception as e:  # noqa: BLE001 the type is the outcome
        return ("error", type(e).__name__)


def _close(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or math.isclose(
            a, b, rel_tol=RTOL, abs_tol=0.0)
    return a == b and type(a) is type(b)


def same(got, want) -> bool:
    if got[0] != want[0] or got[1] != want[1]:
        return False
    if got[0] == "error":
        return True
    return len(got[2]) == len(want[2]) and all(
        len(g) == len(w) and all(_close(a, b) for a, b in zip(g, w))
        for g, w in zip(got[2], want[2]))


def run_script(script, mode, setup=None, jax_kwargs=None, port_kwargs=None):
    """Run `script` through a fresh JAX Session and a fresh port Session
    (after `setup(session)` on each); returns both Sessions and the
    outcomes. Fails at the first statement whose outcomes differ."""
    js = JSession(**(jax_kwargs or {}))
    ts = port_session(mode, **(port_kwargs or {}))
    if setup is not None:
        setup(js)
        setup(ts)
    outs = []
    for item in script:
        stmt, params = item if isinstance(item, tuple) else (item, None)
        want = outcome(js, stmt, params)
        got = outcome(ts, stmt, params)
        assert same(got, want), (stmt, got, want)
        outs.append(got)
    return js, ts, outs
