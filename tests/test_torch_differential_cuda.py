"""tests/test_differential.py's nine cases on the card: the port's
`Session(device="cuda")` (compiled pipeline on, programs captured into
CUDA graphs) against its `Session(device="cpu")` on the same tables
(`torch_differential_cases.make_table_dicts`), a first and a warm (graph
replay) run each: integers and strings exactly, floats to rtol 1e-9. Each
test skips without a CUDA GPU.

This file imports neither jax, the JAX package nor pandas. On the card,
from the root of a checkout:

    python -m pytest --noconftest -q tests/test_torch_differential_cuda.py -m cuda
"""

import pytest
import torch

from query_engine_tpu_torch.engine.session import Session

from torch_differential_cases import (
    CASES, make_table_dicts, rows_in_order, same,
)

pytestmark = pytest.mark.cuda


def _session(device):
    t, d = make_table_dicts()
    s = Session(device=device)
    s.register_table("t", t)
    s.register_table("d", d)
    return s


@pytest.fixture(scope="module")
def sessions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: torch.cuda.is_available() is False")
    return _session("cuda"), _session("cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_on_the_card(case, sessions):
    card, cpu = sessions
    sql, ordered = CASES[case]
    want = rows_in_order(cpu.sql(sql).to_pylist(), ordered)
    for _ in range(2):  # the first run, then a warm one
        same(rows_in_order(card.sql(sql).to_pylist(), ordered), want)
    assert card.executor.pipeline.stats["captures"] >= 1
