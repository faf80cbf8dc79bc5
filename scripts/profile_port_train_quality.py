#!/usr/bin/env python3
"""Which of the TCN chain backward's (K3's) outputs costs the quality
study (``audio_only_speech_separation_tpu_torch/validate.py``) its SI-SDRi,
on one NVIDIA GPU.

    python3 scripts/profile_port_train_quality.py [--seeds 0 1] [--steps 300] [--rescaled 0]

Run from the root of a checkout.  On the study's task and model (full
width, B=4 x 16000 samples at 8 kHz), first the error of each K3 output
(dx, dW1, dWsg, dvecs, dcs, dalphas) against the chain's plain autograd
(``tcn_backward_reference``) at the initial weights and after 150 plain
steps, as a relative l2 norm.  Then the kernel arm of the study (K2
forward, bf16 casts) is trained ``--steps`` Adam steps once with K3's
every output ("k3"), once with the plain autograd's every output
("plain"), and once for each output with that one taken from the plain
autograd and the rest from K3; each run's final model is scored by the
study's PIT SI-SDRi of its f32 forward.  With ``--rescaled n`` the "k3"
and "plain" runs are repeated n times with the estimate scaled by 1 + i *
2^-20 (i = 1..n) before the loss: a change at the level of f32 rounding,
so the repeats' spread is the spread that rounding alone gives the
result.  ``--tail n`` also prints each run's mean SI-SDRi over the models
of its last n steps.  ``--swaps 0`` leaves out the one-output swaps.
Prints the card's name and power limit and one line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

NAMES = ("dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--rescaled", type=int, default=0)
    parser.add_argument("--swaps", type=int, default=1)
    parser.add_argument("--tail", type=int, default=0,
                        help="also score the models of the last n steps and print their mean")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_train_quality: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from audio_only_speech_separation_tpu_torch import validate
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import (
        fused_tcn_backward,
        tcn_backward_reference,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import fused_tcn_separator
    from audio_only_speech_separation_tpu_torch.train import bf16_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_identity()
    print(card)
    dev = torch.device("cuda")
    mix_np, srcs_np = validate.study_data()
    mix, srcs = torch.from_numpy(mix_np).to(dev), torch.from_numpy(srcs_np).to(dev)
    errors = []  # K3 against the plain autograd, (label, {name: rel-l2})

    class MixedChain(torch.autograd.Function):
        """The chain through K2, its backward K3's outputs but those named
        in ``plain``, which come from the plain autograd."""

        plain: tuple = ()
        record: str = ""

        @staticmethod
        def forward(ctx, x, w1s, wsgs, vecs, cs_, alphas, dilations):
            y, y_hist, stats = fused_tcn_separator(x, w1s, wsgs, vecs, cs_, alphas, dilations, save_state=True)
            ctx.dilations = tuple(dilations)
            ctx.save_for_backward(y_hist, y, stats, w1s, wsgs, vecs, cs_, alphas)
            return y

        @staticmethod
        def backward(ctx, g):
            saved = ctx.saved_tensors
            args = (g.contiguous(), *saved, ctx.dilations)
            k3 = fused_tcn_backward(*args)
            if MixedChain.plain or MixedChain.record:
                ref = tcn_backward_reference(*args)
                if MixedChain.record:
                    errors.append((MixedChain.record, {n: cs.rel_l2(r, k) for n, r, k in zip(NAMES, ref, k3)}))
                k3 = tuple(r if n in MixedChain.plain else k for n, r, k in zip(NAMES, ref, k3))
            dtypes = (torch.bfloat16, *(t.dtype for t in saved[3:]))
            return (*(d.to(t) for d, t in zip(k3, dtypes)), None)

    def mixed_chain(x, w1s, wsgs, vecs, cs_, alphas, dilations):
        return MixedChain.apply(x, w1s, wsgs, vecs, cs_, alphas, tuple(dilations))

    loss_fn = validate.PITLossWrapper(validate.pairwise_neg_snr, threshold_byloss=False)
    model = validate.fresh_model(validate.CONVTASNET, dev, 0)
    forward = bf16_forward(model, fused=True, chain=mixed_chain)
    for label, steps in (("initial weights", 0), ("after 150 plain-chain steps", 150)):
        if steps:
            validate.train(model, validate.arm_forward(validate.CONTROL_ARM, model), mix, srcs, steps)
        MixedChain.record = label
        model.zero_grad(set_to_none=True)
        loss_fn(forward(mix), srcs).backward()
        MixedChain.record = ""
    for label, rels in errors:
        print(f"K3 vs the plain autograd, {label}: " + ", ".join(f"{n} {r:.4g}" for n, r in rels.items())
              + f" (rel-l2; {card})")

    variants = [("k3", (), 1.0), ("plain", NAMES, 1.0)]
    variants += [(f"plain {n}", (n,), 1.0) for n in NAMES] if args.swaps else []
    for i in range(1, args.rescaled + 1):
        variants += [(f"k3, estimate x (1 + {i} * 2^-20)", (), 1 + i * 2.0**-20),
                     (f"plain, estimate x (1 + {i} * 2^-20)", NAMES, 1 + i * 2.0**-20)]
    for seed in args.seeds:
        for label, plain, scale in variants:
            MixedChain.plain = plain
            model = validate.fresh_model(validate.CONVTASNET, dev, seed)
            fwd = bf16_forward(model, fused=True, chain=mixed_chain)
            loss, seconds, *tail = validate.train(model, lambda m, f=fwd, c=scale: f(m) * c, mix, srcs, args.steps,
                                                  args.tail)
            with torch.no_grad():
                est = model.eval()(mix).float().cpu().numpy()
            line = {"seed": seed, "run": label, "si_sdri_db": validate.pit_si_sdri(est, srcs_np, mix_np),
                    "final_loss_db": loss, "seconds": seconds}
            if tail:
                line[f"si_sdri_db_mean_of_last_{args.tail}"] = float(np.mean(tail[0]))
            print(json.dumps(line))


if __name__ == "__main__":
    main()
