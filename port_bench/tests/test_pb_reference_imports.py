"""The reference, the comparison and the control import nothing of the
program, of JAX or of the JAX package."""

import subprocess
import sys

from port_bench.tests.conftest import ROOT

CODE = """
import sys
import port_bench.reference.ssb
import port_bench.reference.compare, port_bench.control
bad = sorted({m.split('.')[0] for m in sys.modules}
             & {'query_engine_tpu_torch', 'query_engine_tpu', 'jax',
                'jaxlib', 'flax', 'torch'})
print(','.join(bad))
"""


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_harness_imports_no_jax():
    code = ("import sys, port_bench.run, port_bench.trace, "
            "port_bench.data.ssb\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'query_engine_tpu'})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
