"""What every cell shares: finding its configuration, traffic, limits and
per-layer metrics by name, the seeded weights and signals, the numbers
that decide ``correct``, and the result line.

Everything the harness finds by name is a file of its own:

- ``BENCHMARK.json`` (the checkout's root): the cell's configuration,
  traffic and chips, and which metrics it reports;
- ``configs/<config>.json``: the sizes as run, the reference family, the
  precision, the training settings;
- ``traffic/<traffic>.json``: the mode (``modes/<mode>.py``) and its
  parameters;
- ``limits/<cell>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: a per-layer metric's reader;
- ``reference/<family>.py``: the plain float32 forward, parameter shapes
  and FLOPs.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_only_speech_separation_tpu")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[dict]
    ref: object = field(repr=False, default=None)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, cell_e2e: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in cell_e2e


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with every file it names."""
    bench = bench if bench is not None else load_json(CHECKOUT / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(CHECKOUT / configs[w["config"]]["file"])
    e2e = [m["name"] for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e)]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
                cfg=cfg, traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"), end_to_end=e2e, per_layer=per_layer,
                ref=importlib.import_module(f"port_bench.reference.{cfg['reference']}"))


def load_reader(metric: str):
    """``metrics/<metric>.py`` as a module (its name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def subseed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws (weights, signals, order,
    sample) from the run's seed, of any size."""
    return int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0] >> 1)


WEIGHTS, SIGNALS, ORDER, SAMPLE = range(4)


def make_state_dict(ref, model_args: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's own float32 weights from ``seed``: one uniform draw
    on ``device`` for every leaf at once, each leaf a slice of it in the
    range its reference gives (``param_shapes``: offset +- scale)."""
    leaves = ref.param_shapes(model_args)
    sizes = [math.prod(shape) for _, shape, _, _ in leaves]
    scale = [s for _, _, s, _ in leaves]
    offset = [o for _, _, _, o in leaves]
    g = torch.Generator(device=device).manual_seed(subseed(seed, WEIGHTS))
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    counts = torch.tensor(sizes, device=device)
    flat = (flat * torch.repeat_interleave(torch.tensor(scale, device=device), counts)
            + torch.repeat_interleave(torch.tensor(offset, device=device), counts))
    return {name: t.view(shape) for (name, shape, _, _), t in zip(leaves, flat.split(sizes))}


def build_model(cfg: dict, state_dict, device):
    """The port's model of the configuration, holding ``state_dict``."""
    from audio_only_speech_separation_tpu_torch import models

    model = getattr(models, cfg["model"])(**cfg["model_args"], sample_rate=cfg["sample_rate"], device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def sources(n_items: int, n_src: int, n_samples: int, seed: int, device, gain_db: float) -> torch.Tensor:
    """[n_items, n_src, n_samples] seeded Gaussian sources on ``device``, each
    at its own level: RMS 0.05 at 0 dB, gains uniform in +-``gain_db``."""
    g = torch.Generator(device=device).manual_seed(subseed(seed, SIGNALS))
    s = torch.randn(n_items, n_src, n_samples, generator=g, device=device)
    gains = (torch.rand(n_items, n_src, 1, generator=g, device=device) * 2 - 1) * gain_db
    return s * (0.05 * 10 ** (gains / 20))


def rel_l2(est: np.ndarray, ref: np.ndarray) -> float:
    """||est - ref|| / ||ref|| over every source and sample of one answer."""
    return float(np.linalg.norm((est - ref).ravel()) / max(np.linalg.norm(ref.ravel()), 1e-30))


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> Dict[str, float]:
    """{leaf: |prog norm - ref norm|} over the leaves, each against the
    larger of the leaf's reference norm and the median leaf's."""
    leaves = list(ref) if leaves is None else leaves
    median = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], median, 1e-30) for k in leaves}


def forbidden_loaded() -> List[str]:
    """Modules of ``FORBIDDEN`` in ``sys.modules``, by whole top-level name."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
