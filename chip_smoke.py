#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``audio_only_speech_separation_tpu_torch``)
for ConvTasNet-LRS3 at full width with seeded random weights, through the
whole-separator CUDA kernel, in phases:

0. the card's name and power limit (fails without a CUDA device);
1. build the kernels from ``csrc/`` with nvcc;
2. the kernel against its plain PyTorch version on the card, at the LRS3
   shape and at an odd shape, each also against the f32 eager model;
3. serve five utterances from a checkpoint through ``serve.serve`` with
   bf16, and check each against the f32 eager model and the launch count;
4. time the kernel path, its plain bf16 version and the f32 eager module
   at the bench shape (B=8 x 2 s x 16 kHz).

Every check raises on failure.  The second-to-last line is a JSON object
describing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

# configs/convtasnet_lrs3.yml:3-15 (audionet_config), written out so that
# this script needs no YAML reader
LRS3 = dict(N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=3,
            activate="relu", causal=False, n_src=3, sample_rate=16000)
SR = 16000
KERNEL_SOURCE = "audio_only_speech_separation_tpu_torch/csrc/convtasnet_separator.cu"
TPU_KERNEL = "audio_only_speech_separation_tpu/ops/pallas/convtasnet_block.py:74"


def card_identity() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def random_jax_tree(cfg, seed: int):
    """Seeded ConvTasNet weights in the JAX package's parameter layout,
    with random norm affines, biases and PReLU slopes (some above 1)."""
    rng = np.random.default_rng(seed)
    N, L, B, H = cfg["N"], cfg["L"], cfg["B"], cfg["H"]

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def vec(n, center=0.0, scale=0.1):
        return (center + scale * rng.standard_normal(n)).astype(np.float32)

    def alpha():
        return rng.uniform(0.05, 1.5, size=(1,)).astype(np.float32)

    p = {
        "encoder": {"kernel": w(L, N, fan_in=L)},
        "bn_norm": {"gamma": vec(N, 1.0), "beta": vec(N)},
        "bn_conv": {"kernel": w(N, B, fan_in=N), "bias": vec(B)},
        "mask_conv": {"kernel": w(B, cfg["num_spks"] * N, fan_in=B), "bias": vec(cfg["num_spks"] * N)},
        "decoder": {"kernel": w(N, L, fan_in=N)},
    }
    for r in range(cfg["R"]):
        for i in range(cfg["X"]):
            p[f"tcn_{r}_{i}"] = {
                "conv1x1": {"kernel": w(B, H, fan_in=B), "bias": vec(H)},
                "act1": {"alpha": alpha()},
                "norm1": {"gamma": vec(H, 1.0), "beta": vec(H)},
                "dwconv": {"Conv_0": {"kernel": w(3, 1, H, fan_in=3), "bias": vec(H)}},
                "act2": {"alpha": alpha()},
                "norm2": {"gamma": vec(H, 1.0), "beta": vec(H)},
                "sconv": {"kernel": w(H, B, fan_in=H), "bias": vec(B)},
            }
    return {"params": p}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_rule(label: str, kernel_err: float, plain_err: float) -> None:
    """The kernel must be as close to f32 as the plain bf16 version is:
    kernel error <= 1.5 * plain error + 1e-3 (the JAX package's validator
    rule, scripts/validate_pallas.py:148)."""
    bound = 1.5 * plain_err + 1e-3
    print(f"  {label}: kernel-vs-f32 {kernel_err:.6g}  plain-vs-f32 {plain_err:.6g}  bound {bound:.6g}")
    if not kernel_err <= bound:
        raise AssertionError(f"{label}: kernel error {kernel_err} exceeds {bound}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    from audio_only_speech_separation_tpu_torch.models import ConvTasNet, from_pretrain, save_serialized
    from audio_only_speech_separation_tpu_torch.models.convtasnet import (
        fused_inference_forward,
        inference_frames,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels import _build
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
        convtasnet_separator_reference,
        fused_convtasnet_separator,
        pack_convtasnet_full_params,
    )
    from audio_only_speech_separation_tpu_torch.serve import serve
    from audio_only_speech_separation_tpu_torch.utils.jax_import import convtasnet_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_identity()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: card {card}")

    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    print(f"phase 1: built {os.path.relpath(path)} in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    def model_for(cfg, seed):
        m = ConvTasNet(**cfg, device=dev)
        sd = convtasnet_from_jax(random_jax_tree(cfg, seed), cfg["R"], cfg["X"])
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        return m.eval()

    # ---- phase 2: kernel vs plain version, and both vs the f32 model
    print("phase 2: kernel vs plain version on the card")
    errs = {}
    cases = [("lrs3", LRS3, 2, 2 * SR), ("odd", dict(LRS3, num_spks=2, n_src=2, activate="sigmoid"), 2, 9999)]
    for name, cfg, batch, T in cases:
        model = model_for(cfg, seed=1)
        packed = pack_convtasnet_full_params(model.state_dict(), cfg["R"], cfg["X"], cfg["num_spks"], device=dev)
        x = torch.from_numpy(np.random.default_rng(2).standard_normal((batch, T)).astype(np.float32)).to(dev)
        with torch.no_grad():
            ref = model(x)
            got = fused_inference_forward(model, x, packed=packed)
            plain = fused_inference_forward(model, x, packed=packed, separator=convtasnet_separator_reference)
            # the separator alone on the frames the path gives it
            frames = inference_frames(model, x)
            *w, dils = packed
            kw = dict(dilations=dils, nspk=cfg["num_spks"], sigmoid=cfg["activate"] == "sigmoid")
            sep_k = fused_convtasnet_separator(frames, *w, **kw)
            sep_again = fused_convtasnet_separator(frames, *w, **kw)
            sep_p = convtasnet_separator_reference(frames, *w, **kw)
        torch.cuda.synchronize()
        if not torch.equal(sep_k, sep_again):
            raise AssertionError(f"{name}: two kernel runs differ")
        for out in (got, plain):
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
        errs[name] = max_err(sep_k, sep_p)
        print(f"  {name}: T={T} spk={cfg['num_spks']} {cfg['activate']}: separator kernel-vs-plain "
              f"max abs {errs[name]:.6g} (frames scale {float(sep_p.float().abs().max()):.4g})")
        check_rule(name, max_err(got, ref), max_err(plain, ref))

    # ---- phase 3: serve a few requests from a checkpoint
    print("phase 3: serve 5 requests (bf16, 1 s buckets, batch 2)")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best_model.pth")
        save_serialized({"model_name": "ConvTasNet", "state_dict": random_jax_tree(LRS3, 3),
                         "model_args": LRS3, "infos": {}}, ckpt)
        model = from_pretrain(ckpt, device=dev).eval()
    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(int(s * SR)).astype(np.float32) for s in (1.3, 2.0, 2.0, 3.7, 4.0)]
    fused_convtasnet_separator.launches = 0
    est = serve(model, wavs, use_bf16=True, device=dev, bucket_seconds=1.0, batch_size=2)
    torch.cuda.synchronize()
    launches = fused_convtasnet_separator.launches
    n_batches, per_call = 3, 2 + 2 * LRS3["R"] * LRS3["X"]
    print(f"  launches {launches} (want {n_batches} batches x {per_call})")
    if launches != n_batches * per_call:
        raise AssertionError(f"launch count {launches} != {n_batches * per_call}")
    ref = serve(model, wavs, use_bf16=False, device=dev, bucket_seconds=1.0, batch_size=2)
    packed = pack_convtasnet_full_params(model.state_dict(), 3, 8, 3, device=dev)
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
    for start in range(0, len(order), 2):  # the plain version on serve's batches
        idxs = order[start : start + 2]
        T_pad = -(-max(len(wavs[i]) for i in idxs) // SR) * SR
        mix = np.zeros((len(idxs), T_pad), np.float32)
        for j, i in enumerate(idxs):
            mix[j, : len(wavs[i])] = wavs[i]
        with torch.no_grad():
            plain = fused_inference_forward(model, torch.from_numpy(mix).to(dev), packed=packed,
                                            separator=convtasnet_separator_reference)
        for j, i in enumerate(idxs):
            T = len(wavs[i])
            if est[i].shape != (3, T) or not np.isfinite(est[i]).all():
                raise AssertionError(f"request {i}: bad estimate {est[i].shape}")
            p_i = plain[j, :, :T].float().cpu()
            check_rule(f"request {i} ({T / SR:.1f} s)", float(np.abs(est[i] - ref[i]).max()),
                       float((p_i - torch.from_numpy(ref[i])).abs().max()))

    # ---- phase 4: timing at the bench shape
    print(f"phase 4: timing, B=8 x 2 s x 16 kHz, 3 speakers, on {card}")
    model = model_for(LRS3, seed=5)
    packed = pack_convtasnet_full_params(model.state_dict(), 3, 8, 3, device=dev)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 2 * SR)).astype(np.float32)).to(dev)
    frames = inference_frames(model, x)
    *w, dils = packed
    kw = dict(dilations=dils, nspk=3)
    runs = {
        "kernel path": lambda: fused_inference_forward(model, x, packed=packed),
        "plain bf16 path": lambda: fused_inference_forward(
            model, x, packed=packed, separator=convtasnet_separator_reference),
        "f32 eager module": lambda: model(x),
        "separator kernel": lambda: fused_convtasnet_separator(frames, *w, **kw),
        "separator plain": lambda: convtasnet_separator_reference(frames, *w, **kw),
    }
    times = {k: [] for k in runs}
    with torch.no_grad():
        for fn in runs.values():
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        for _ in range(20):
            for name, fn in runs.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    ms = {k: statistics.median(v) for k, v in times.items()}
    for name, t in ms.items():
        print(f"  {name}: {t:.4f} ms/call, {8 * 2.0 / (t / 1000):.2f} audio-sec/s "
              f"(median of 20, {card})")

    print(json.dumps({"kernels": [{
        "name": "convtasnet_separator", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "max_abs_err": errs["lrs3"],
        "ms": ms["separator kernel"], "plain_ms": ms["separator plain"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
