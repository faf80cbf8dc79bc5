#!/usr/bin/env python3
"""Where the port's two LSTM paths cross over on one NVIDIA GPU: K5's path
(``ops/rnn.py::recurrence_form``: the library input product, then the
recurrence kernel) against K6 (``resident_bilstm``: the input product
inside), bf16, over a grid of shapes.

    python3 scripts/profile_port_lstm_crossover.py [--out grid.json] [--calls 5] [--reps 3]

Run from the root of a checkout: it imports that checkout's
``audio_only_speech_separation_tpu_torch``.  The grid is T in {8, 24, 32,
42, 82, 100, 128, 250, 501}, sequences B in {1, 4, 8, 16, 32, 42, 64, 100,
128, 200, 256, 512, 1048}, (Din, H) in {(32, 64), (64, 128), (128, 128),
(128, 256)} and D in {1, 2}: every (T, B, Din, H, D) the served families
hand the LSTM wrappers at B=1 and B=8 lies on it or between its points.
Each time is ``measure_gates.event_ms`` (the median over ``--reps`` of
``--calls`` back-to-back calls between CUDA events, after two warm-up
calls), so it includes the host's work around each kernel as a served
call does.  Prints the card's name and power limit, one row a point (both
times, the faster path and K5's time over K6's) and, at the end, the point
count each path wins by D and (Din, H); ``--out`` also writes the rows as
JSON.  The plain scan is not timed: it never came within 10x of either
kernel (``measure_gates``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TS = (8, 24, 32, 42, 82, 100, 128, 250, 501)
BS = (1, 4, 8, 16, 32, 42, 64, 100, 128, 200, 256, 512, 1048)
WIDTHS = ((32, 64), (64, 128), (128, 128), (128, 256))
DS = (1, 2)


def card_identity() -> str:
    """``nvidia-smi``'s name and power limit of the card, as one line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="write the rows to this JSON file as well")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_lstm_crossover: no CUDA device")
    sys.path.insert(0, os.getcwd())
    from audio_only_speech_separation_tpu_torch.measure_gates import event_ms
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import resident_bilstm
    from audio_only_speech_separation_tpu_torch.ops.rnn import kernel_choice, recurrence_form

    dev = torch.device("cuda")
    card = card_identity()
    print(card, flush=True)
    rng = np.random.default_rng(3)

    def rand(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)

    rows, t0 = [], time.perf_counter()
    print("T, B, Din, H, D: K5's path ms, K6 ms, faster, K5/K6, the rule's choice", flush=True)
    with torch.no_grad():
        for Din, H in WIDTHS:
            for D in DS:
                w_ih, w_hh = rand((D, Din, 4 * H), 0.08), rand((D, H, 4 * H), 0.05)
                bias = rand((D, 4 * H), 0.05, torch.float32)
                for T in TS:
                    for B in BS:
                        x = rand((B, T, Din), 0.5)
                        k5 = event_ms(lambda: recurrence_form(x, w_ih, w_hh, bias), args.calls, args.reps)
                        k6 = event_ms(lambda: resident_bilstm(x, w_ih, w_hh, bias), args.calls, args.reps)
                        row = {"T": T, "B": B, "Din": Din, "H": H, "D": D, "K5": k5, "K6": k6,
                               "faster": "K5" if k5 < k6 else "K6", "choice": kernel_choice(T, B, Din, H, D)}
                        rows.append(row)
                        print(f"{T}, {B}, {Din}, {H}, {D}: {k5:.4f}, {k6:.4f}, {row['faster']}, {k5 / k6:.3f}, "
                              f"{row['choice']}", flush=True)
                del w_ih, w_hh, bias
    print(f"{len(rows)} points in {time.perf_counter() - t0:.1f} s; {card}")
    for Din, H in WIDTHS:
        for D in DS:
            mine = [r for r in rows if (r["Din"], r["H"], r["D"]) == (Din, H, D)]
            k5 = [(r["T"], r["B"]) for r in mine if r["faster"] == "K5"]
            print(f"Din {Din}, H {H}, D {D}: K5's path faster at {len(k5)} of {len(mine)} points (T, B): {k5}")
    off = [r for r in rows if r["choice"] != r["faster"] and r[r["choice"]] > 1.1 * r[r["faster"]]]
    print(f"the rule's choice more than 10 % slower than the faster path at {len(off)} of {len(rows)} grid points")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "calls": args.calls, "reps": args.reps, "rows": rows}, f)


if __name__ == "__main__":
    main()
