"""The Sandglasset serving cell run with a fault planted in the program, for
the readings its limit (``limits/sandglasset_wsj0.*.json``) is set from,
beside ``calibrate.py``'s program and control readings: the fault changes
the model the server is built from (``serve_faults.planted``), never the
weights or the reference the answers are compared with.

- ``fault_last_block_skip_lost``: the last block attends without the
  mirrored skip of the first block's global path, as a sandglass that
  paired its blocks wrongly would.

    python3 -m port_bench.sandglasset_faults --workload <cell> --seeds <n ...> [--seconds 2]

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


def _last_block_skip_lost(model):
    from audio_only_speech_separation_tpu_torch.models.sandglasset import SandglassetBlock

    class SkipLost(SandglassetBlock):
        def forward(self, x, skip_connect=None):
            return super().forward(x)

    model.sep_net[-1].__class__ = SkipLost  # a class of its own survives the server's copy of the module


FAULTS = {"fault_last_block_skip_lost": _last_block_skip_lost}


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
        print("sandglasset_faults: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        for kind, checks in readings(cell, seed, args.seconds, torch.device("cuda", 0)).items():
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
