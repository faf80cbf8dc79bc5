"""Batch sweeps of the latency-bound families on one card (counterpart of
``scripts/bench_batch_sweep.py`` and ``scripts/bench_tdanet_fast.py``):
bf16, 2 s clips, timed as ``bench_all`` times a row.

    python -m audio_only_speech_separation_tpu_torch.bench_batch_sweep [sweep ...] [--iters N]
    python -m audio_only_speech_separation_tpu_torch.bench_batch_sweep dptnet --device cpu --batches 1 --seconds 0.1 --iters 1

Sandglasset at B = 8, 16, 32; Sepformer at 2, 4, 8; DPTNet at 8, 16, 32
(``scripts/bench_batch_sweep.py:27-48``, each through ``serve.Server``'s
"kernels": the bf16 module, K4-K6); TDANet's fast path ("fast_tdanet") and
its module path ("kernels", K4) at 4, 8, 16 (``scripts/bench_tdanet_fast.py``;
the JAX sweep's "tdanet" is that module path).  One line a batch: ms a
call, audio-seconds a second, GFLOP per audio-second and the share of the
bf16 peak, as ``bench_all`` counts them.  A batch that raises prints
FAILED and the sweep goes on; the process then exits with 1.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .bench_all import CASES, ITERS, SECONDS, bench_one, device_name, row_line

_ROWS = {name: ctor for name, ctor, _, _, _ in CASES}
# name -> (model constructor, sample rate, batches, path); the constructors are bench_all's rows'
SWEEPS = {
    "sandglasset": (_ROWS["Sandglasset (defaults)"], 8000, (8, 16, 32), "kernels"),
    "sepformer": (_ROWS["Sepformer (base)"], 16000, (2, 4, 8), "kernels"),
    "dptnet": (_ROWS["TasNet-DPTNet (wsj0)"], 8000, (8, 16, 32), "kernels"),
    "tdanet-fast": (_ROWS["TDANet (lrs2)"], 16000, (4, 8, 16), "fast_tdanet"),
    "tdanet-module": (_ROWS["TDANet (lrs2)"], 16000, (4, 8, 16), "kernels"),
}


def main(argv=None) -> list:
    """The sweeps named (all by default); returns their rows.  Raises
    SystemExit(1) at the end when a batch failed."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sweeps", nargs="*", choices=[[]] + list(SWEEPS), default=[])
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (the plain versions)")
    parser.add_argument("--batches", type=int, nargs="+", default=None, help="in place of each sweep's batches")
    parser.add_argument("--seconds", type=float, default=SECONDS)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    print(f"batch sweeps, bf16, {args.seconds:g} s clips, on {device_name(dev)}", flush=True)
    rows = []
    for name in args.sweeps or list(SWEEPS):
        ctor, sr, batches, path = SWEEPS[name]
        torch.manual_seed(0)
        model = ctor()
        for batch in args.batches or batches:
            label = f"{name} b={batch}"
            try:
                r = bench_one(label, model, sr, batch, path, dev, args.iters, args.seconds)
            except Exception as e:  # the sweep goes on, as the JAX script's does; the exit code says so
                print(f"{label}: FAILED ({type(e).__name__}: {str(e)[:200]})", flush=True)
                rows.append({"name": label, "path": path, "failed": f"{type(e).__name__}: {e}"})
                continue
            finally:
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            print(row_line(r), flush=True)
            rows.append(r)
    if any("failed" in r for r in rows):
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
