#!/usr/bin/env python3
"""Device times of the port's dual-path kernels (attention K4, the LSTM
recurrences K5 and K6) and of the DPTNet and DPRNN calls that run them, on
one NVIDIA GPU.

    python3 scripts/profile_port_dualpath.py [--reps 20]

Run from the root of a checkout: it imports that checkout's
``audio_only_speech_separation_tpu_torch`` and the helpers of its
``chip_smoke.py`` (seeded models and inputs, CUDA-event timing, the
torch.profiler breakdown), so the same script measures any commit of the
port; run it from two checkouts in turns in one process tree to compare
them on one card.  Prints the card's name and power limit, then:

- K4 at DPTNet's rows [1344, 16, 100] and columns [3200, 16, 42] (B=8 x
  2 s), K5 at the batch-1 12 s column pass (T 242, D 2, B 100, H 128), K6
  at DPRNN's rows (T 100, B 336, Din 64, H 128): each its median time over
  ``--reps`` CUDA-event-timed calls and its device time by kernel
  (torch.profiler, 5 calls);
- DPTNet and DPRNN (wsj0 configs, full width and depth, seeded weights) at
  B=8 x 2 s and B=1 x 12 s x 8 kHz through the bf16 kernel path: the
  median call time, the device time of K4, K5, K6 and of all device work a
  call (torch.profiler, 3 calls), and the idle share against the call time.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

KERNEL_NAMES = ("attention", "lstm")  # the dual-path kernels' names contain these


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_dualpath: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import fused_attention_bdt
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import fused_bilstm, resident_bilstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_identity()
    print(card)
    rand = cs.rand_maker(26, dev)

    def by_kernel(fn, calls):
        return ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:g} launches)" for k, v in cs.profile_kernels(fn, calls).items()
                         if any(n in k for n in KERNEL_NAMES))

    q, k, v = (rand((1344, 16, 100)) for _ in range(3))
    qc, kc, vc = (rand((3200, 16, 42)) for _ in range(3))
    xw, whh = rand((242, 2, 100, 512), 0.3), rand((2, 128, 512), 0.05)
    x6, wih6, whh6, b6 = (rand((336, 100, 64), 0.5), rand((2, 64, 512), 0.08), rand((2, 128, 512), 0.05),
                          rand((2, 512), 0.05, torch.float32))
    kernels = {
        "K4 [1344, 16, 100]": lambda: fused_attention_bdt(q, k, v),
        "K4 [3200, 16, 42]": lambda: fused_attention_bdt(qc, kc, vc),
        "K5 (242, 2, 100, 128)": lambda: fused_bilstm(xw, whh),
        "K6 (100, 336, 64, 128, 2)": lambda: resident_bilstm(x6, wih6, whh6, b6),
    }
    with torch.no_grad():
        for name, fn in kernels.items():
            ms = cs.cuda_time(fn, reps=args.reps, warmup=3)
            print(f"{name}: {ms:.4f} ms a call (median of {args.reps}, CUDA events, {card}); by kernel "
                  f"(torch.profiler): {by_kernel(fn, 5)}")

    for module, seed in (("DPTNet", 21), ("DPRNN", 22)):
        kernel_path = cs.tasnet_paths(cs.tasnet_model(module, seed, dev))[0]
        for batch, secs in ((8, 2.0), (1, 12.0)):
            x = torch.from_numpy(np.random.default_rng(25).standard_normal(
                (batch, int(secs * cs.TSR))).astype(np.float32)).to(dev)
            ms = cs.cuda_time(lambda: kernel_path(x), reps=args.reps, warmup=3)
            rows = cs.profile_kernels(lambda: kernel_path(x), 3)
            busy = sum(t for t, _ in rows.values())
            print(f"{module} B={batch} x {secs:g} s kernel path: {ms:.4f} ms a call (median of {args.reps}, "
                  f"{batch * secs / (ms / 1000):.2f} audio-sec/s, {card}); device work {busy:.4f} ms a call, "
                  f"idle share {1 - busy / ms:.4f}; dual-path kernels (torch.profiler, per call): "
                  + ", ".join(f"{k} {t:.4f} ms ({n:g} launches)" for k, (t, n) in rows.items()
                              if any(s in k for s in KERNEL_NAMES)))


if __name__ == "__main__":
    main()
