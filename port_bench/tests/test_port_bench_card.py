"""On the card (marked ``cuda``; each test skips without one): every cell
runs through ``port_bench.run`` and comes out correct, and the control at
the cell's own size comes out as not correct.

    python3 -m pytest port_bench/tests -m cuda
"""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import calibrate, harness, run as bench_run
from port_bench.tests.small import cell_names

SEED = 2**31 + 4099


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card and has no CPU fallback")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_cell_correct_on_the_card(card, name, capsys):
    assert bench_run.main(["--workload", name, "--seed", str(SEED), "--seconds", "2", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_control_not_correct_at_the_cells_size(card, name):
    cell = harness.load_cell(name)
    if cell.traffic["mode"] == "serve":
        checks = calibrate.control_serve(cell, SEED, card)
    else:
        checks, _ = calibrate.control_train(cell, SEED, card)
    assert any(checks[k] > cell.limits[k] for k in cell.limits), checks
