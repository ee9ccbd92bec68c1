"""On the card: each cell's run at its own size comes out correct, and the
control (the program's ``x32`` path) comes out not correct.  Skipped where
there is no CUDA card; decided inside the test.  Run on the card with

    python3 -m pytest benchmark/tests/test_bench_card.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def cards():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("the benchmark's cells run only on a CUDA card")
    return torch.cuda.device_count()


def _cells():
    return [(w["name"], w["chips"])
            for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(workload, seed, precision=None):
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
           "--seconds", "3", "--trace", "0"] + (["--precision", precision] if precision else [])
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload,chips", _cells())
def test_a_cell_comes_out_correct_and_its_control_not(cards, workload, chips):
    if cards < chips:
        pytest.skip(f"{workload} needs {chips} cards")
    assert _run(workload, 2**31 + 11)["correct"]
    assert not _run(workload, 2**31 + 12, precision="x32")["correct"]
