"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size, in one process:

- the program: every number compared, for each of ``--seeds``, after a
  window of ``--seconds`` (a training cell's numbers need none);
- the control, for each of ``--control-seeds``: the reference itself in
  the program's place, its products rounded to float8 e4m3
  (``reference.common.fp8``), one precision below the configuration's
  bfloat16, compared by the same numbers;
- with ``--faults``, for each control seed, a training cell's step with a
  fault planted under it: half of its batch left out (the loss the mean
  over the other half), and the gradient of the model's last leaf (the
  decoder's filters) lost before the optimizer's step.

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3 [--faults]

One JSON line a reading on standard output, and the lot in
``chiprun_out/calibrate_<cell>.jsonl`` under the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

from . import harness
from .modes import serve, train
from .reference.common import fp8


def control_serve(cell, seed: int, device) -> dict:
    sd = harness.make_state_dict(cell.ref, cell.cfg["model_args"], seed, device)
    traffic = serve.Traffic(cell, seed, device)
    answered = {i: None for i in range(len(traffic.requests))}
    worst = 0.0
    for i in serve.check_sample(traffic, answered, cell.traffic["check_requests"], seed):
        worst = max(worst, serve.request_error(cell, sd, traffic, traffic.requests[i], None, device, fp8))
    return {"serve_rel_err": worst}


def control_train(cell, seed: int, device) -> dict:
    sd = harness.make_state_dict(cell.ref, cell.cfg["model_args"], seed, device)
    batches = train.make_pool(cell, seed, device)[:cell.traffic["checked_steps"]]
    losses, first, change = train.reference_readings(cell, sd, batches, q=fp8)
    return train.compare(cell, sd, batches, losses, first, change)


@contextlib.contextmanager
def half_batch():
    """The step trains on the first half of each batch only."""
    call = train.Step.__call__

    def broken(self, mix, src, step, **kw):
        h = mix.shape[0] // 2
        return call(self, mix[:h], src[:h], step, **kw)

    train.Step.__call__ = broken
    try:
        yield
    finally:
        train.Step.__call__ = call


@contextlib.contextmanager
def last_leaf_grad_lost():
    """The optimizer's step finds the last leaf's gradient zeroed."""
    from audio_only_speech_separation_tpu_torch.train.optimizers import Optimizer

    step = Optimizer.step

    def broken(self):
        self.params[-1].grad.zero_()
        return step(self)

    Optimizer.step = broken
    try:
        yield
    finally:
        Optimizer.step = step


FAULTS = {"fault_half_batch": half_batch, "fault_last_leaf_grad_lost": last_leaf_grad_lost}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    mode = serve if cell.traffic["mode"] == "serve" else train
    out_dir = harness.CHECKOUT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    lines = []

    def emit(kind, seed, checks, **extra):
        line = {"cell": cell.name, "kind": kind, "seed": seed, "checks": checks, **extra}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        run = mode.run(cell, seed, args.seconds, False, device, t)
        emit("program", seed, run.checks, attempted=run.attempted, failed=run.failed,
             end_to_end=run.end_to_end, comparison=run.read.get("comparison"))
    for seed in args.control_seeds:
        if mode is serve:
            emit("control", seed, control_serve(cell, seed, device))
        else:
            checks, info = control_train(cell, seed, device)
            emit("control", seed, checks, comparison=info)
        for kind, fault in FAULTS.items() if args.faults and mode is train else ():
            with fault():
                run = mode.run(cell, seed, 0.0, False, device, time.perf_counter())
            emit(kind, seed, run.checks, comparison=run.read.get("comparison"))
    with open(Path(out_dir) / f"calibrate_{cell.name}.jsonl", "a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
