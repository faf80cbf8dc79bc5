"""The inference benchmark of the port (counterpart of the root ``bench.py``):
separated audio-seconds a second on one card, ConvTasNet-LRS3 served in
bf16 through the whole-separator kernel K1.

    python -m audio_only_speech_separation_tpu_torch.bench
    python -m audio_only_speech_separation_tpu_torch.bench --device cpu --batch 1 --seconds 0.25 --iters 2

Prints one JSON line with the root bench's keys, ``{"metric":
"convtasnet_lrs3_infer_throughput", "value": ..., "unit":
"audio-sec/sec/chip", "vs_baseline": ...}``, and ``device``, the name of
what it ran on.  The shape is the root bench's (``bench.py:86-122``): B=8
utterances of 2 s at 16 kHz, ConvTasNet at configs/convtasnet_lrs3.yml's
width (3 speakers, relu mask), seeded weights packed once, bf16 through
``fused_inference_forward``.

On the card the bench first checks K1 against its plain version on the
bench's frames, once, and raises if they differ by more than
``K1_PLAIN_REL`` of the plain output's largest magnitude (``chip_smoke.py``
phase 2's rule).  That check takes the place of the root bench's refusal
of kernels whose validation record is stale (``bench.py:49-84``): it costs
one plain call, so the port keeps no record of source hashes.  Then
``ITERS`` calls run back to back between two CUDA events, after a warm-up,
with no profiler and no ``torch.compile``.

``--device cpu`` runs the same path through K1's plain version, which a CPU
tensor selects, timed by the host clock (there is no kernel to check):
a check of the control flow at a tiny shape, not a measurement of the card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .models import ConvTasNet
from .models.convtasnet import fused_inference_forward, inference_frames
from .ops.kernels.convtasnet_block import (
    convtasnet_separator_reference,
    fused_convtasnet_separator,
    pack_convtasnet_full_params,
)

# The root bench's baseline (bench.py:19-23, :44): an analytic estimate for an
# A100 running the same config, ~51 GFLOP per audio-second at ~20 % of
# 312 bf16 TFLOP/s, rounded to 1000 audio-sec/s.  It was measured on no chip;
# vs_baseline = value / A100_EST.
A100_EST = 1000.0

BATCH = 8
SECONDS = 2.0
SAMPLE_RATE = 16000
ITERS = 100

# configs/convtasnet_lrs3.yml:3-15 (audionet_config), as the root bench builds it
LRS3 = dict(N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=3, activate="relu",
            causal=False, sample_rate=SAMPLE_RATE)

# K1 against its plain version: the largest difference within this share of
# the plain output's largest magnitude (chip_smoke.py's K1_PLAIN_REL)
K1_PLAIN_REL = 3e-2


def check_kernel(model: ConvTasNet, x: torch.Tensor, packed) -> float:
    """K1 against its plain version on ``x``'s frames; raises past
    ``K1_PLAIN_REL``.  Returns the max abs difference."""
    *w, dils = packed
    frames = inference_frames(model, x)
    with torch.no_grad():
        got = fused_convtasnet_separator(frames, *w, dilations=dils, nspk=model.num_spks)
        plain = convtasnet_separator_reference(frames, *w, dilations=dils, nspk=model.num_spks)
    err = float((got.float() - plain.float()).abs().max())
    scale = float(plain.float().abs().max())
    if not err <= K1_PLAIN_REL * scale:
        raise RuntimeError(f"bench: K1 differs from its plain version by {err} > {K1_PLAIN_REL} x {scale}; "
                           "no number is reported for it")
    return err


def time_calls(call, dev: torch.device, iters: int) -> float:
    """Seconds of ``iters`` calls of ``call`` back to back after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    call()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def run(device="cuda", batch: int = BATCH, seconds: float = SECONDS, iters: int = ITERS) -> dict:
    """The benchmark at ``batch`` x ``seconds``; returns the JSON line's
    object."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; pass device=\"cpu\" to run the plain version on the CPU")
    model = ConvTasNet(**LRS3, device=dev).eval()
    T = int(seconds * SAMPLE_RATE)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(batch, T)).astype(np.float32)).to(dev)
    packed = pack_convtasnet_full_params(model.state_dict(), model.R, model.X, model.num_spks, device=dev)
    x = x.to(torch.bfloat16)
    if dev.type == "cuda":
        check_kernel(model, x, packed)

    def call():
        with torch.no_grad():
            return fused_inference_forward(model, x, packed=packed)

    dt = time_calls(call, dev, iters)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    throughput = batch * seconds * iters / dt
    return {"metric": "convtasnet_lrs3_infer_throughput", "value": round(throughput, 2),
            "unit": "audio-sec/sec/chip", "vs_baseline": round(throughput / A100_EST, 3), "device": name}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (the plain version)")
    parser.add_argument("--batch", type=int, default=BATCH)
    parser.add_argument("--seconds", type=float, default=SECONDS)
    parser.add_argument("--iters", type=int, default=ITERS)
    args = parser.parse_args(argv)
    result = run(args.device, args.batch, args.seconds, args.iters)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
