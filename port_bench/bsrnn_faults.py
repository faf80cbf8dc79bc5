"""The BSRNN serving cell run with a fault planted in the program, for the
readings its limit (``limits/bsrnn_wsj0.*.json``) is set from, beside
``calibrate.py``'s program and control readings: the fault changes the
model the server is built from (``serve_faults.planted``), never the
weights or the reference the answers are compared with.

- ``fault_widest_band_prelu_lost``: the widest band's mask-head PReLU slope
  is lost (read as 0, a ReLU), as a band-batched head that took the
  padded slot of another band would lose it.

    python3 -m port_bench.bsrnn_faults --workload <cell> --seeds <n ...> [--seconds 2]

One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .modes import serve
from .serve_faults import planted


def _widest_band_prelu_lost(model):
    widest = max(range(model.nband), key=lambda i: model.band_width[i])
    with torch.no_grad():
        model.mask[widest][6].weight.zero_()


FAULTS = {"fault_widest_band_prelu_lost": _widest_band_prelu_lost}


def readings(cell, seed: int, seconds: float, device) -> dict:
    """{fault: the cell's checks} of one seed, each fault in its own run."""
    out = {}
    for kind, fault in FAULTS.items():
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
        print("bsrnn_faults: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for kind, checks in readings(cell, seed, args.seconds, torch.device("cuda", 0)).items():
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
