"""Each mode end to end on the CPU at small widths, through the port's
plain versions: set-up, the window, the comparison with the reference and
the result line; and the trace path with its readers."""

from __future__ import annotations

import json
import time

import pytest
import torch

from audio_only_speech_separation_tpu_torch.ops import kernels
from port_bench import harness, run as bench_run
from port_bench.modes import serve, train
from port_bench.tests.small import cell_names, small_cell

CPU = torch.device("cpu")
SEED = 2**31 + 2**20 + 11  # past 32 signed bits, as the driver's are


def mode_of(cell):
    return serve if cell.traffic["mode"] == "serve" else train


@pytest.mark.parametrize("name", cell_names())
def test_mode_runs_end_to_end(name):
    cell = small_cell(name)
    with kernels.plain_versions():
        run = mode_of(cell).run(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert run.attempted > 0 and run.failed == 0
    assert set(run.checks) == set(cell.limits)
    assert all(run.checks[k] < cell.limits[k] for k in cell.limits), run.checks
    assert all(v > 0 for v in run.end_to_end.values()) and set(cell.end_to_end) <= set(run.end_to_end)
    line = bench_run.result_line(cell, run, False, harness.load_json(harness.CHECKOUT / "BENCHMARK.json"))
    assert line["correct"] is True and list(line)[-1] == "checks"
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", ["convtasnet_lrs3.serve_b8_2s", "convtasnet_lrs3.train_b12_2s"])
def test_trace_path_reads(name):
    """A traced stretch on the CPU: no device operation, so the device
    readers find nothing and leave their metrics out; the rate readers
    read the untraced part."""
    cell = small_cell(name)
    run = mode_of(cell).run(cell, SEED, 0.6, True, CPU, time.perf_counter())
    assert run.trace is not None and run.trace.window_s > 0 and run.trace.device == []
    got = bench_run.per_layer(cell, run)
    mfu = "mfu." + cell.traffic["mode"]
    assert set(got) == {mfu}, got
    assert run.trace.idle_gaps() and run.trace.idle_gaps()[0][0].startswith("bench.")


def test_same_seed_same_inputs():
    cell = small_cell("convtasnet_lrs3.serve_b8_2s")
    a, b = serve.Traffic(cell, SEED, CPU), serve.Traffic(cell, SEED, CPU)
    c = serve.Traffic(cell, SEED + 1, CPU)
    assert [a.item(r) for r in range(20)] == [b.item(r) for r in range(20)]
    assert all((x == y).all() for q, p in zip(a.requests, b.requests) for x, y in zip(q, p))
    assert sorted(len(u) for q in a.requests for u in q) == sorted(len(u) for q in c.requests for u in q)


def test_every_cycle_serves_the_whole_pool():
    """Each cycle of the order sends every request of the pool once."""
    cell = small_cell("convtasnet_lrs3.serve_b8_2s")
    t = serve.Traffic(cell, SEED, CPU)
    n = len(t.requests)
    for k in range(0, 4 * n, n):
        assert sorted(t.item(r) for r in range(k, k + n)) == list(range(n))
    assert [t.item(r) for r in range(n)] != [t.item(r) for r in range(n, 2 * n)] or n < 3


def test_pool_lengths_are_the_traffics():
    cell = harness.load_cell("convtasnet_lrs3.serve_b8_2s")
    lengths = serve.pool_lengths(cell.traffic, cell.cfg["sample_rate"])
    assert lengths == [32000] * (16 * 8)
