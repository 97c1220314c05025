"""Each cell of BENCHMARK.json, run briefly on the card by the benchmark's
command, must read correct; and the control must read not correct at the
cell's own size. Needs a CUDA device: ``python3 -m pytest -m cuda
pplp_bench/tests/test_pplp_bench_card.py`` on the card; skips elsewhere."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from pplp_bench import control
from pplp_bench.tests import tiny

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((tiny.REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    done = subprocess.run([sys.executable, "pplp_bench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 101), "--seconds", "3", "--trace", "0"],
                          cwd=tiny.REPO, capture_output=True, text=True, timeout=1200)
    assert done.returncode == 0, done.stderr[-3000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    got = control.readings(tiny.REPO, cell, 2**31 + 103, 24, "cuda")
    assert any(v > lim for v, lim in got.values()), got
