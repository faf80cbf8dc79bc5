"""Serving cells run with a fault planted in the program, for the readings
the limits of ``limits/<cell>.json`` are set from (beside
``calibrate.py``'s program and control readings): each fault changes the
model the server is built from, never the weights or the reference the
answers are compared with.

- ``fault_inter_positions_left_out`` (Sepformer): the first dual block's
  inter stack adds no sinusoidal positions;
- ``fault_block_prelu_lost`` (ConvTasNet): the first TCN block's first
  PReLU slope is lost (read as 0, a ReLU).

    python3 -m port_bench.serve_faults --workload <cell> --seeds <n ...> [--seconds 2]

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import harness
from .modes import serve


def _inter_positions_left_out(model):
    model.masknet.dual_mdl[0].inter_mdl.pos_enc = None


def _block_prelu_lost(model):
    with torch.no_grad():
        model.separation.sep[0].tcn[0].prelu1.weight.zero_()


FAULTS = {"sepformer": {"fault_inter_positions_left_out": _inter_positions_left_out},
          "convtasnet": {"fault_block_prelu_lost": _block_prelu_lost}}


@contextlib.contextmanager
def planted(fault):
    """``harness.build_model`` gives the model with ``fault`` applied."""
    build = harness.build_model

    def broken(cfg, state_dict, device):
        model = build(cfg, state_dict, device)
        fault(model)
        return model

    harness.build_model = broken
    try:
        yield
    finally:
        harness.build_model = build


def readings(cell, seed: int, seconds: float, device) -> dict:
    """{fault: the cell's checks} of one seed, each fault of the cell's
    reference family in its own run."""
    out = {}
    for kind, fault in FAULTS[cell.cfg["reference"]].items():
        with planted(fault):
            out[kind] = serve.run(cell, seed, seconds, False, device, time.perf_counter()).checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_faults: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for kind, checks in readings(cell, seed, args.seconds, torch.device("cuda", 0)).items():
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
