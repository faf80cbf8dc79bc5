#!/usr/bin/env python3
"""Per-kernel device times of the port's ConvTasNet separator (K1) and TCN
chain forward (K2) at the bench shapes, on one NVIDIA GPU.

    python3 scripts/profile_port_block_body.py [--reps 10]

Run from the root of a checkout: it imports that checkout's
``audio_only_speech_separation_tpu_torch`` and the helpers of its
``chip_smoke.py`` (random weights, inputs, CUDA-event timing and the
torch.profiler breakdown), so the same script measures any commit of the
port.  K1 takes B=8 x 2 s x 16 kHz ConvTasNet-LRS3 frames, K2 the TCN chain
at B=12 x 2 s (T' = 8003, 24 blocks, H 512).  Prints the card's name and
power limit, each kernel's median time over ``--reps`` CUDA-event-timed
calls, and its device time by kernel (torch.profiler, 3 calls).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_block_body: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from audio_only_speech_separation_tpu_torch.models import ConvTasNet
    from audio_only_speech_separation_tpu_torch.models.convtasnet import inference_frames
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
        fused_convtasnet_separator,
        fused_tcn_separator,
        pack_convtasnet_full_params,
    )
    from audio_only_speech_separation_tpu_torch.utils.jax_import import convtasnet_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_identity()
    model = ConvTasNet(**cs.LRS3, device=dev)
    sd = convtasnet_from_jax(cs.random_jax_tree(cs.LRS3, 5), cs.LRS3["R"], cs.LRS3["X"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    model.eval()
    *w, dils = pack_convtasnet_full_params(model.state_dict(), 3, 8, 3, device=dev)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 2 * cs.SR)).astype(np.float32)).to(dev)
    xc, wc, dc, _ = cs.chain_inputs(dev, 24, 512, cs.TRAIN_B, cs.train_frames(2 * cs.SR), seed=7)
    with torch.no_grad():
        frames = inference_frames(model, x)
        runs = {
            "K1 (B=8 x 2 s x 16 kHz)": lambda: fused_convtasnet_separator(frames, *w, dilations=dils, nspk=3),
            f"K2 (B={cs.TRAIN_B} x 2 s)": lambda: fused_tcn_separator(xc, *wc, dc, save_state=True),
        }
        print(card)
        for name, fn in runs.items():
            ms = cs.cuda_time(fn, reps=args.reps)
            by_kernel = cs.profile_kernels(fn, 3)
            print(f"{name}: {ms:.4f} ms a call (median of {args.reps}, CUDA events, {card}); by kernel "
                  "(torch.profiler): " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:g} launches)"
                                                   for k, v in by_kernel.items()))


if __name__ == "__main__":
    main()
