"""Kernel launches and host time of a training cell's step, by phase.

    python3 -m port_bench.launches --workload convtasnet_lrs3.train_b12_2s --seed <n> [--steps 5]

from the root of a checkout, on one CUDA card.  Builds the cell's step as
``modes/train.py`` does (the same weights, batches and step body), warms
it up, times ``--steps`` steps untraced, then traces as many under
``torch.profiler`` with the step's ``bench.*`` phase spans on.  Prints one
JSON object: the untraced step's mean ms; a step's launches (the host's
``cudaLaunchKernel`` and ``cuLaunchKernel`` calls) and device operations;
and for each phase (``zero_grad``, ``forward``, ``loss``, ``backward``,
``optimizer``) its launches and traced host ms a step.  A launch belongs
to the phase whose span holds it in time, so the backward's, issued on
autograd's thread, fall in ``backward``.  The profiler costs the host
about as much again as the step, so the phases' ms are traced ones;
their launches are not changed by it.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from . import harness, trace as tracing
from .modes import train

PHASES = ("zero_grad", "forward", "loss", "backward", "optimizer")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")  # and their Ex / ExC forms


def count(cell, seed: int, steps: int, device) -> dict:
    """The readings above, of ``steps`` traced steps of ``cell`` after as
    many untraced ones (and the cell's checked steps, to warm up)."""
    sd = harness.make_state_dict(cell.ref, cell.cfg["model_args"], seed, device)
    pool = train.make_pool(cell, seed, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as exp_dir:
        step = train.Step(cell, sd, seed, device, exp_dir)
        k = 0
        for _ in range(cell.traffic["checked_steps"]):
            step(*pool[k % len(pool)], k)
            k += 1
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*pool[k % len(pool)], k)
            k += 1
        sync()
        untraced_ms = (time.perf_counter() - t0) * 1e3 / steps
        with tracing.profiled() as holder:
            for _ in range(steps):
                step(*pool[k % len(pool)], k, on=True)
                k += 1
            sync()
    return dict({"workload": cell.name, "seed": seed, "steps": steps, "untraced_step_ms": untraced_ms},
                **tally(holder.trace, steps))


def tally(tr, steps: int) -> dict:
    """A step's launches and device operations in the trace ``tr`` of
    ``steps`` steps, in all and by phase, with each phase's host ms."""
    launches = [s for name, s, _ in tr.host_ops if name.startswith(LAUNCHES)]
    phases = {}
    for phase in PHASES:
        spans = [(s, e) for name, s, e in tr.spans if name == f"bench.{phase}"]
        inside = sum(1 for t in launches if any(s <= t <= e for s, e in spans))
        phases[phase] = {"launches": inside / steps, "host_ms": sum(e - s for s, e in spans) / 1e6 / steps}
    return {"launches_a_step": len(launches) / steps, "device_ops_a_step": len(tr.device) / steps,
            "phases": phases}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="convtasnet_lrs3.train_b12_2s")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if cell.traffic["mode"] != "train":
        raise SystemExit(f"port_bench.launches: {args.workload} is not a training cell")
    if not torch.cuda.is_available():
        raise SystemExit("port_bench.launches: needs a CUDA card")
    print(json.dumps(count(cell, args.seed, args.steps, torch.device("cuda"))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
