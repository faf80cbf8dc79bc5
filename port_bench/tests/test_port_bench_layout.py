"""BENCHMARK.json and the files it names: every configuration, traffic
mix, limit, reference and per-layer metric is a file of its own that the
harness finds by name, and the file keeps to the benchmark's contract."""

from __future__ import annotations

import importlib
import re

import pytest
import torch

from port_bench import harness
from port_bench.tests.small import cell_names, config_names

BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
COMPARED = {"serve": {"serve_rel_err"},
            "train": {"loss1_gap_db", "grad_gap_median_leaf", "change_gap_median_leaf", "grad_gap_worst_multi_leaf",
                      "change_gap_worst_multi_leaf"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and BENCH["command"][:3] == ["python3", "-m", "port_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", cell_names())
def test_cell_files_found_by_name(name):
    cell = harness.load_cell(name, BENCH)
    assert set(cell.limits) == COMPARED[cell.traffic["mode"]]
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:  # a per-layer metric's cell reports the metric it moves
        assert m["moves"] in cell.end_to_end
        assert callable(harness.load_reader(m["name"]).read)
    for key in ("mode", "why", "batch", "pool", "gain_db", "trace_seconds"):
        assert key in cell.traffic
    assert len(cell.traffic["why"]) <= 200


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_run_configuration(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = harness.load_json(harness.CHECKOUT / entry["file"])
    assert cfg["name"] == name and cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert cfg["precision"] == "bfloat16" and "assumed" in cfg


@pytest.mark.parametrize("name", config_names())
def test_reference_shapes_are_the_models(name):
    """The reference's parameters are the port's model's, name for name and
    shape for shape, at the published widths; the benchmark's weights load
    into it."""
    cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
    ref = importlib.import_module(f"port_bench.reference.{cfg['reference']}")
    sd = harness.make_state_dict(ref, cfg["model_args"], 2**31 + 7, torch.device("cpu"))
    model = harness.build_model(cfg, sd, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


def test_state_dict_depends_on_the_seed_alone():
    cell = harness.load_cell(cell_names()[0], BENCH)
    args = dict(cell.cfg["model_args"], X=1, R=1)
    a = harness.make_state_dict(cell.ref, args, 3**20, torch.device("cpu"))
    b = harness.make_state_dict(cell.ref, args, 3**20, torch.device("cpu"))
    c = harness.make_state_dict(cell.ref, args, 3**20 + 1, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["mask.weight"], c["mask.weight"])
    assert torch.all(a["separation.sep.0.tcn.0.prelu1.weight"].sub(0.25).abs() <= 0.05)


def test_forbidden_modules_by_whole_top_level_name():
    import sys

    assert "audio_only_speech_separation_tpu_torch" not in harness.FORBIDDEN
    sys.modules["audio_only_speech_separation_tpu.fake_probe"] = sys
    try:
        assert "audio_only_speech_separation_tpu" in harness.forbidden_loaded()
    finally:
        del sys.modules["audio_only_speech_separation_tpu.fake_probe"]
