"""Manual model benchmark (counterpart of the root ``unit_tests.py``;
reference unit_tests.py:14-42): builds a model from the port registry,
reports its parameters and forward FLOPs (``utils.profiling``), then times
a few f32 train steps (PIT loss over ``pairwise_neg_snr``, backward, the
clip at 5.0 and Adam) on seeded random tensors.

    python -m audio_only_speech_separation_tpu_torch.unit_tests --model TasNet --module DPRNN --epochs 5
    python -m audio_only_speech_separation_tpu_torch.unit_tests --device cpu --length 800 --batch 1 --epochs 1

On the card the steps are timed between two CUDA events after one warm-up
step; with ``--device cpu`` by the host clock.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import models
from .losses import PITLossWrapper, pairwise_neg_snr
from .train import make_optimizer
from .utils.profiling import count_params, estimate_cost


def test_model(model, length: int = 32000, batch: int = 4, epochs: int = 5, n_src: int = 2,
               device="cuda") -> dict:
    """Parameters, forward FLOPs and ``epochs`` timed train steps of
    ``model`` (already on ``device``) at ``batch`` x ``length`` samples."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    mix = torch.from_numpy(rng.normal(size=(batch, length)).astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.normal(size=(batch, n_src, length)).astype(np.float32)).to(dev)
    params = count_params(model)
    print(f"params: {params / 1e6:.3f} M")
    cost = estimate_cost(model, mix)
    per_audio_sec = cost["flops"] / (batch * length / model.sample_rate)
    print(f"forward flops: {cost['flops'] / 1e9:.2f} G ({per_audio_sec / 1e9:.2f} G/audio-sec)")

    loss_fn = PITLossWrapper(pairwise_neg_snr, threshold_byloss=False)
    opt = make_optimizer(model.parameters(), optim_name="adam", lr=1e-3, grad_clip=5.0)

    def step():
        opt.zero_grad()
        loss = loss_fn(model(mix), src)
        loss.backward()
        opt.step()
        return loss

    step()  # the first step, untimed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(epochs):
            loss = step()
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(epochs):
            loss = step()
        dt = time.perf_counter() - t0
    lf = float(loss.detach())
    print(f"{epochs} steps: {dt:.3f}s ({dt / epochs * 1000:.1f} ms/step), loss {lf:.3f}")
    return {"params": params, "flops": cost["flops"], "ms_per_step": dt / epochs * 1e3, "loss": lf}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="TasNet")
    parser.add_argument("--module", default="DPRNN")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--length", type=int, default=32000)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("unit_tests: no CUDA device; pass --device cpu to run on the CPU")
    cls = models.get(args.model)
    if args.model == "TasNet":
        model = cls(module=args.module, sample_rate=8000, device=dev)
    else:
        model = cls(sample_rate=8000, device=dev)
    print(f"=== {args.model}" + (f"/{args.module}" if args.model == "TasNet" else "") + " ===")
    return test_model(model.train(), length=args.length, batch=args.batch, epochs=args.epochs, device=dev)


if __name__ == "__main__":
    main()
