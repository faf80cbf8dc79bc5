"""The benchmark's cells at small widths and short traffic, for the CPU.

Each configuration's cut is a file of its own, ``sizes/<config>.json``:
``model_args`` (widths and depths cut for the CPU) and, for each mode,
the traffic parameters that replace the cell's."""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path

from port_bench import harness

SIZES = Path(__file__).resolve().parent / "sizes"


def sizes(config_name: str) -> dict:
    return harness.load_json(SIZES / f"{config_name}.json")


def small_config(config_name: str):
    """(configuration at its small widths, its reference module)."""
    cfg = harness.load_json(harness.HERE / "configs" / f"{config_name}.json")
    cfg = dict(cfg, model_args=dict(cfg["model_args"], **sizes(config_name)["model_args"]))
    return cfg, importlib.import_module(f"port_bench.reference.{cfg['reference']}")


def small_cell(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json at its configuration's small
    widths with short traffic."""
    cell = harness.load_cell(name)
    cut = sizes(cell.config_name)
    cfg = dict(cell.cfg, model_args=dict(cell.cfg["model_args"], **cut["model_args"]))
    return dataclasses.replace(cell, cfg=cfg, traffic=dict(cell.traffic, **cut[cell.traffic["mode"]]))


def cell_names():
    return [w["name"] for w in harness.load_json(harness.CHECKOUT / "BENCHMARK.json")["workloads"]]


def config_names():
    """Every configuration file, those of cells kept for a later PR too."""
    return sorted(p.stem for p in (harness.HERE / "configs").glob("*.json"))
