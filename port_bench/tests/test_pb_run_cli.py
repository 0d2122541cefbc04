"""The command exits non-zero and prints no result without a card, and in
a directory that holds only BENCHMARK.json and the benchmark's files."""

import shutil
import subprocess
import sys

from port_bench.tests.conftest import ROOT

ARGS = ["-m", "port_bench.run", "--workload", "ssb-sf10.flight1", "--seed",
        "5", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return      # the card's case is the benchmark's own runs
    out = subprocess.run([sys.executable, *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 4, out.stderr
    assert out.stdout.strip() == ""
