"""On the card only (marker ``card``; skips on a machine without one):
the control at a cell's own size, and one short run of each cell."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import Spec
from benchmark.tests.tiny import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(card, workload):
    from benchmark import control
    from benchmark.reference import compare

    spec = Spec(REPO)
    cell = spec.cell(workload)
    cfg, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    numbers = control.control_numbers(cfg, mix, 3_000_000_051, 64, card)
    correct, _, _ = compare.verdict(numbers, cfg["limits"])
    assert correct is False


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_of_the_cell_is_correct(card, workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "3000000052", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=360, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
