"""At a tiny scale on the CPU, the port's Session gives the reference's rows
for every query text (the measured path on the card is not run here)."""

import pytest

from port_bench import run
from port_bench.reference.compare import compare
from port_bench.tests.conftest import SEED, tiny

CELLS = {"ssb": "ssb-sf10.star"}


@pytest.fixture(scope="module", params=sorted(CELLS))
def family(request):
    import importlib

    from query_engine_tpu_torch.engine.session import Session

    spec, cell, config, mix = run.cell_files(CELLS[request.param])
    config = tiny(config)
    generator = importlib.import_module(config["generator"])
    tables = generator.generate(config, SEED, "cpu")
    host = {k: v.host() for k, v in tables.items()}
    session = Session(device="cpu")
    run.register(session, tables, "cpu")
    reference = importlib.import_module(config["reference"])
    return session, host, reference, run.queries(config, mix)


def test_every_text_agrees(family):
    session, host, reference, texts = family
    assert len(texts) == 13
    nonempty = 0
    for q, text in texts.items():
        got = session.sql(text).to_pylist()
        want = reference.run(q, host)
        wrong, gap = compare(got, want, reference.ORDER[q])
        assert not wrong, (q, got[:3], want[:3])
        assert gap <= 1e-10, (q, gap)
        nonempty += bool(want) and want != [(None,)]
    assert nonempty >= len(texts) - 4
