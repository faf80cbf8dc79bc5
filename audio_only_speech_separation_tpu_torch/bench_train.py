"""Train-step throughput on one card (counterpart of
``scripts/bench_train.py``): forward, PIT loss over ``pairwise_neg_snr``,
backward, the global-norm clip at 5.0 and Adam, for every case of the JAX
script's ``CASES`` at its batch, segment and precision mode.

    python -m audio_only_speech_separation_tpu_torch.bench_train [--only ConvTasNet] [--iters 30] [--out r.json]
    python -m audio_only_speech_separation_tpu_torch.bench_train --device cpu --only "DPRNN (wsj0, b8x4s)" \\
        --batch 1 --seconds 0.1 --iters 1

Precision modes: ``float32`` runs the module; ``bfloat16`` the port
Trainer's bf16 cast policy (``train.bf16_forward``: the module on bf16
casts of the f32 parameters); the ConvTasNet forms on the same casts:
``+fused`` ``make_fused_train_apply`` (K1 as the primal, the backward
through the plain bf16 module), ``+delayed`` ``make_delayed_train_apply``
(the kernels' delayed-norm algebra as plain ops), ``+kernelbwd``
``make_kernel_train_apply`` (the TCN chain through K2 and K3).  The
models run in eval mode, as the JAX script applies them (no dropout), so
on the card the attention and LSTM layers take K4, K5 and K6.

Each case warms up for two steps, then ``--iters`` steps run back to back
between two CUDA events.  One line a case, ``name: ms/step,
trained-audio-sec/s, loss``; a case that fails prints FAILED with the
error, as the JAX script does.  ``--out`` writes every case's result as
JSON with the card's name.  ``--device cpu`` (with ``--batch`` and
``--seconds`` to shrink the cases) times the host clock: a check of the
control flow, not a measurement of the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import models as M
from .bench import LRS3
from .losses import PITLossWrapper, pairwise_neg_snr
from .models.convtasnet import make_delayed_train_apply, make_fused_train_apply, make_kernel_train_apply
from .train import bf16_forward, make_optimizer

WSJ0_TASNET = dict(enc_dim=64, bn_dim=64, hidden_dim=128, win=16, layer=6, num_spk=2, block_size=100,
                   sample_rate=8000)

# (name, model constructor, sample rate, batch, speakers, precision): scripts/bench_train.py:24-47
CASES = [
    ("ConvTasNet (lrs3, b8x2s)", lambda: M.ConvTasNet(**LRS3), 16000, 8, 3, "float32"),
    ("ConvTasNet (lrs3, b8x2s, bf16)", lambda: M.ConvTasNet(**LRS3), 16000, 8, 3, "bfloat16"),
    ("ConvTasNet (lrs3, b8x2s, bf16+fusedfwd)", lambda: M.ConvTasNet(**LRS3), 16000, 8, 3, "bfloat16+fused"),
    ("ConvTasNet (lrs3, b8x2s, bf16+CL)", lambda: M.ConvTasNet(**LRS3, channels_last=True), 16000, 8, 3,
     "bfloat16"),
    ("ConvTasNet (lrs3, b8x2s, bf16+delayed)", lambda: M.ConvTasNet(**LRS3), 16000, 8, 3, "bfloat16+delayed"),
    ("ConvTasNet (lrs3, b8x2s, bf16+kernelbwd)", lambda: M.ConvTasNet(**LRS3), 16000, 8, 3,
     "bfloat16+kernelbwd"),
    ("ConvTasNet (lrs3, b8x2s, f32+CL)", lambda: M.ConvTasNet(**LRS3, channels_last=True), 16000, 8, 3,
     "float32"),
    ("ConvTasNet (lrs3, b16x2s, bf16+kernelbwd)", lambda: M.ConvTasNet(**LRS3), 16000, 16, 3,
     "bfloat16+kernelbwd"),
    ("TasNet-DPRNN (wsj0, b8x4s)", lambda: M.TasNet(**WSJ0_TASNET, module="DPRNN"), 8000, 8, 2, "float32"),
    ("TasNet-DPRNN (wsj0, b8x4s, bf16)", lambda: M.TasNet(**WSJ0_TASNET, module="DPRNN"), 8000, 8, 2,
     "bfloat16"),
    ("BSRNN (wsj0, b8x4s, bf16)", lambda: M.BSRNN(win=256, stride=64, feature_dim=128, num_spks=2,
                                                 num_repeat=8, sample_rate=8000), 8000, 8, 2, "bfloat16"),
    ("TasNet-DPTNet (wsj0, b8x4s, bf16)", lambda: M.TasNet(**WSJ0_TASNET, module="DPTNet"), 8000, 8, 2,
     "bfloat16"),
    ("Sepformer (base, b2x2s, bf16)", lambda: M.Sepformer(sample_rate=16000), 16000, 2, 2, "bfloat16"),
    ("TDANet (lrs2, b4x2s, bf16)", lambda: M.TDANet(out_channels=128, in_channels=512, num_blocks=16,
                                                    upsampling_depth=5, enc_kernel_size=4, num_sources=2,
                                                    sample_rate=16000), 16000, 4, 2, "bfloat16"),
    ("AFRCNN (lrs2, b4x2s, bf16)", lambda: M.AFRCNN(out_channels=512, in_channels=512, num_blocks=16,
                                                    upsampling_depth=5, enc_kernel_size=1, num_sources=2,
                                                    sample_rate=16000), 16000, 4, 2, "bfloat16"),
    ("Sandglasset (b8x4s, bf16)", lambda: M.Sandglasset(sample_rate=8000), 8000, 8, 2, "bfloat16"),
]

SECONDS = {8000: 4.0, 16000: 2.0}
ITERS = 30
WARMUP = 2

_FORMS = {"+fused": make_fused_train_apply, "+delayed": make_delayed_train_apply,
          "+kernelbwd": make_kernel_train_apply}


def make_forward(model, precision: str):
    """est = forward(mix) in f32 for ``precision`` (see the module
    docstring)."""
    if precision == "float32":
        return model
    base, _, form = precision.partition("+")
    if base != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    return bf16_forward(model, apply_fn=_FORMS["+" + form](model) if form else None)


def bench_case(name, ctor, sr, batch, n_src, precision, device="cuda", iters: int = ITERS,
               seconds: float | None = None) -> dict:
    """One case: ``iters`` timed steps after ``WARMUP``; returns its
    result (ms a step, trained audio-seconds a second, the last loss)."""
    dev = torch.device(device)
    secs = SECONDS[sr] if seconds is None else seconds
    T = int(secs * sr)
    torch.manual_seed(0)
    model = ctor().to(dev).eval()
    rng = np.random.default_rng(0)
    mix = torch.from_numpy(rng.normal(size=(batch, T)).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.normal(size=(batch, n_src, T)).astype(np.float32)).to(dev)
    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)
    opt = make_optimizer(model.parameters(), optim_name="adam", lr=1e-3, grad_clip=5.0)
    forward = make_forward(model, precision)

    def step():
        opt.zero_grad()
        loss = loss_fn(forward(mix), src)
        loss.backward()
        opt.step()
        return loss

    for _ in range(WARMUP):
        step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            loss = step()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step()
        dt = time.perf_counter() - t0
    return {"name": name, "precision": precision, "batch": batch, "seconds": secs,
            "ms_per_step": dt / iters * 1e3, "trained_audio_sec_per_s": batch * secs * iters / dt,
            "loss": float(loss.detach()), "iters": iters}


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=None, help="substring filter on case names")
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--out", default=None, help="write the results as JSON here")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    parser.add_argument("--batch", type=int, default=None, help="every case's batch (default: its own)")
    parser.add_argument("--seconds", type=float, default=None, help="every case's segment (default: its own)")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_train: no CUDA device; pass --device cpu to run on the CPU")
    results = []
    for name, ctor, sr, batch, n_src, precision in CASES:
        if args.only and args.only.lower() not in name.lower():
            continue
        try:
            r = bench_case(name, ctor, sr, args.batch or batch, n_src, precision, dev, args.iters, args.seconds)
        except Exception as e:  # a case's failure is reported and the rest still run, as in the JAX script
            print(f"{name}: FAILED ({type(e).__name__}: {str(e)[:150]})", flush=True)
            results.append({"name": name, "precision": precision, "failed": f"{type(e).__name__}: {e}"})
            continue
        print(f"{name}: {r['ms_per_step']:.1f} ms/step, {r['trained_audio_sec_per_s']:.0f} trained-audio-sec/s, "
              f"loss {r['loss']:.2f}", flush=True)
        results.append(r)
    if args.out:
        device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        with open(args.out, "w") as f:
            json.dump({"device": device, "cases": results}, f, indent=1)
    return results


if __name__ == "__main__":
    main()
