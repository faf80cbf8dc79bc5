#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path and its training path
(``audio_only_speech_separation_tpu_torch``) for ConvTasNet-LRS3 at full
width and depth with seeded random weights: serving through the
whole-separator CUDA kernel (K1), training through the TCN chain's forward
(K2) and backward (K3) CUDA kernels.  Then the TasNet dual-path serving
path (DPTNet and DPRNN on the wsj0 configs, 8 kHz) through the attention
(K4) and LSTM (K5, K6) CUDA kernels, Sepformer (sepformer_base, 16 kHz)
through K4, and the eval CLI (``audio_test.main``) over all three
families; then BSRNN (bsrnn_wsj0, 8 kHz) through K5 and K6, TDANet
(tdanet_lrs2, 16 kHz) on its module path through K4 and on its
analytic fast path, AFRCNN (afrcnn_lrs2), and the eval CLI over those
three; the elementwise probe K7 (``scripts/micro_vpu.py``'s function);
training on the card for every served family through ``Trainer``'s
bf16 cast policy (K4-K6 in the forward, their backwards through the plain
versions); then the rest of the model zoo: Sandglasset (K4 in its 3-D and
4-D forms, K6), DPRNNTasNet (K5, K6) and TasNet's other separator modules
and group communication, served, through the eval CLI and in a train
step; then the training-quality study, the main path's training with
remat, lamb and a cosine schedule, the optimizers written after optax's
rules, MixIT and the two-step entry.  In phases:

0. the card's name and power limit (fails without a CUDA device);
1. build the kernels from ``csrc/`` with nvcc;
2. K1 against its plain PyTorch version on the card, at the LRS3 shape and
   at an odd shape, each also against the f32 eager model;
3. serve five utterances from a checkpoint through ``serve.serve`` with
   bf16, and check each against the f32 eager model and the launch count;
4. time the K1 path, its plain bf16 version and the f32 eager module at
   the bench shape (B=8 x 2 s x 16 kHz), with K1's kernels timed one by one
   under torch.profiler beside the device bytes the design moves;
5. K2 against its plain version at the LRS3 train shape (B=12 x 2 s);
6. K3 against its plain version (autograd of the plain chain): at full
   width and depth under the JAX validator's rule, and at a small case
   where every cotangent must be within 6e-2;
7. one train step at B=2 x 2 s: kernel-path gradients against the
   plain-chain path's, and both against the f32 module's;
8. train with ``audio_train.main`` on synthetic LRS3-shaped manifests
   (3 speakers, 2 s, batch 12, 3 optimizer steps) through K2 and K3, then
   serve the best_model.pth it wrote through K1 with phase 3's checks;
9. time a train step of the kernel path, the plain bf16 path and the f32
   module, and K2 and K3 alone against their plain versions, at B=12 x 2 s,
   with K2's and K3's kernels timed one by one under torch.profiler (K2's
   beside the device bytes its design moves);
10. K4 against its plain version at the JAX validator's shapes, DPTNet's
    and the kernel's edges (T around a 16-query tile, long T, dh 8 and 256);
11. K5 and 12. K6 against their plain versions at the validator's shapes,
    the batch-1 inter-chunk pass, an odd batch, one step, H 48 and 256, and
    batches past one cluster a tile;
13. one backward through each of K4, K5 and K6 against autograd of its
    plain version;
14. DPTNet and DPRNN end to end at B=2 x 2 s and B=1 x 12 s: the kernel
    path (bf16), the plain bf16 path and the f32 module;
15. serve five requests (1.3 to 12 s) of each model from a checkpoint
    through ``serve.serve`` (bf16, batch 1, 1 s buckets); K4 (DPTNet), K5
    and K6 must each launch;
16. time both models at B=8 x 2 s and at B=1 x 12 s x 8 kHz (kernel path,
    plain bf16 path, f32 module), profile the kernel path (K4, K5, K6
    device time and launches, idle share), and time K4, K5 and K6 alone
    beside their plain versions and the PyTorch calls that compute the
    same (or, for K5, a similar) function; K5 and K6 also per step, with
    the thread-block cluster they take, K6 also at K5's batch-1 shape;
17. Sepformer at full width and depth, seeded weights, at B=2 x 2 s and
    B=1 x 8 s: the kernel path (``serve``'s "kernels" dispatch), the plain
    bf16 path and the f32 module under the 1.5x rule, exactly 32 K4
    launches a call; K4 against its plain version at the two shapes of
    B=2 x 2 s ([544, 32, 250] intra, [4000, 32, 34] inter);
18. the eval CLI, ``audio_test.main(config, device="cuda")`` with --bf16,
    on phase 8's ConvTasNet-LRS3 experiment (K1), a DPTNet at 8 kHz (K4,
    K5, K6) and phase 17's Sepformer (K4), each on five synthetic
    utterances of 1.3-8 s: well-formed CSV files whose rows equal the
    port's ``MetricsTracker`` on ``serve()``'s estimates within 1e-3 dB;
19. time the Sepformer at B=2 x 2 s (kernel path, plain bf16 path, f32
    module; the kernel path profiled: K4, the library matmuls, the rest,
    the idle share), and K4 alone at its two shapes beside its plain
    version, SDPA on [B, h, T, dh] and its bound;
20. BSRNN at full width and depth, seeded weights, at B=1 and 4 x 4 s: the
    kernel path (``serve``'s "kernels"), the plain bf16 path and the f32
    module under the 1.5x rule, exactly 8 K5 (the band RNNs, (501, 2, 8B,
    256)) and 8 K6 (the band-comm RNNs, (8, 501B, 128, 256)) launches a
    call; K5 and K6 against their plain versions at those shapes;
21. TDANet at full width and depth at B=1 and 2 x 2 s: the module path in
    bf16 (16 K4 launches a call, at [1008, 64, B]) under the 1.5x rule; the
    fast path ("fast_tdanet") in bf16 with no K4 launch and an SNR against
    the f32 module above 20 dB, and in f32 within 1e-4 of the f32 module's
    scale; K4 against its plain version at TDANet's two shapes;
22. AFRCNN at full width and depth at B=1 x 2 s: the bf16 module against
    the f32 module, no kernel launched;
23. the eval CLI as in phase 18 on BSRNN (8 kHz; "kernels", K5 and K6, no
    K4), TDANet ("fast_tdanet", no kernel) and AFRCNN ("kernels", no
    kernel);
24. time BSRNN at B=1 and 4 x 4 s (kernel path, plain bf16 path, f32
    module, median of 3; the kernel path profiled), K5 and K6 alone at BSRNN's B=1
    shapes beside their plain versions, bf16 ``nn.LSTM`` on the same shape
    and their bounds (K5 also a step), a TDANet call on the fast path and
    on the module path (both profiled), and an AFRCNN call;
25. the elementwise probe K7 (``ops/kernels/micro_vpu.py``) against its
    plain version at the script's [2048, 512] in f32 and bf16, with and
    without stats (bf16 bit for bit), at the script's slope (min select)
    and at 0.75 (max select), then its four timed cases (one launch
    a call) beside their bounds (the CUDA cores' rate at the max SM clock)
    and the earlier design's times, and the bf16x2 / f32 rate ratio;
26. one bf16 train step of DPRNN, DPTNet and BSRNN (their wsj0 configs'
    full width, batch and segment) through the kernels, inside
    ``plain_versions()`` and in f32: the gradient rule of PERF.md section 2,
    exact forward launches of K4, K5 and K6, none in the backward;
27. ``audio_train.main`` with bf16 for each served family (DPRNN, DPTNet,
    BSRNN, Sepformer, TDANet, AFRCNN) at its config's full width, batch and
    segment, one epoch of two steps: finite losses, exact K4-K6 launches
    (none in a Sepformer or TDANet train step: dropout), and the
    best_model.pth served on the card;
28. each family's train step timed (kernel path, plain bf16 path, f32; the
    kernel path split into forward, backward and optimizer and profiled),
    and for BSRNN the backward of K5 and K6 through their plain versions;
29. Sandglasset at its defaults (8 kHz, full width and depth) at B=8 and
    1 x 2 s: the kernel path (``serve``'s "kernels") with exactly 6 K4 (two
    in the 4-D batched-axis form) and 6 K6 launches a call and no call of
    a plain version, the plain bf16 path and the f32 module under the 1.5x
    rule; then each kernel against its plain version at every shape the
    kernel path's calls gave it, recorded as they ran (K4 at [16000, 16,
    131], [3968, 16, 131], [960, 16, 131] and their B=1 shapes, K6 at
    (250, 1048 and 131, 128, 128)), and those shapes must be the ones
    ``sandglasset_shapes`` states for phase 33;
30. DPRNNTasNet at its defaults (8 kHz) the same way at B=8 (12 K6) and
    B=1 (12 K5) x 2 s, K5 and K6 against their plain versions at the row
    and column shapes its calls gave them (H 256; stated in
    DPRNN_TASNET_K5 and DPRNN_TASNET_K6);
31. TasNet at the wsj0 widths with each other separator module (TCN,
    SudoRMRF; GC_TCN, GC_SudoRMRF, DPRNN and DPTNet with group size 2) at
    B=8 x 2 s the same way, with the launches of TASNET_MODULES, and K4,
    K5 and K6 against their plain versions at every shape those calls
    gave them (the context GC_RNNs' and the grouped cores' LSTMs at Din
    32, H 64; DPTNet's attention at dh 8);
32. the eval CLI as in phase 18 on Sandglasset (K4, K6), DPRNNTasNet (K5)
    and the DPTNet TasNet with group size 2 (K4, K5, K6);
33. time Sandglasset and DPRNNTasNet at B=8 and B=1 x 2 s (kernel path,
    plain bf16 path, f32 module; the kernel path profiled), K4 alone at
    Sandglasset's three shapes beside its plain version, SDPA and its
    bound, and K6 and K5 alone at Sandglasset's and DPRNNTasNet's shapes
    beside their plain versions, bf16 ``nn.LSTM`` and their bounds;
34. one bf16 train step of Sandglasset and DPRNNTasNet (B=2 x 2 s) three
    ways as in phase 26, exact forward launches, none in the backward;
35. the training-quality study (``validate.py``, the JAX script's
    ``kernel_train_quality``, through its command line in a process of
    its own) at full width: 300 Adam steps a run, f32
    from seed 0, bf16 and bf16 through K2 + K3 from six seeds, each run's
    SI-SDRi after the last step and over the last 50 steps' models, final
    loss and seconds, and the script's two thresholds as gates (the
    training gate on the mean over the seeds of the tail averages'
    difference, with its standard error; the script's reading at seed 0
    printed beside, ungated);
36. ``audio_train.main`` on the LRS3 config (B=12 x 2 s) with
    ``fused_forward``, ``remat``, lamb and CosineAnnealingLR for three
    steps and validation: 2 x 49 K2 and 170 K3 launches a step; one
    step's gradients with remat bit-identical to one without; the step's
    time and peak device memory either way;
37. the optimizers written after optax's rules, three steps each on the
    card against the CPU (1e-5 relative);
38. MixIT on the card against the CPU (1e-5 relative);
39. the two-step entry on TDANet (tdanet_lrs2 width): step 2's ``sm``
    parameters are step 1's best_model.pth's after the warm start.

TF32 is off for matmuls and cuDNN, so the f32 references are full f32.

Every check raises on failure.  The second-to-last line is a JSON object
describing the kernels; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

# configs/convtasnet_lrs3.yml:3-15 (audionet_config), written out so that
# this script needs no YAML reader
LRS3 = dict(N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN", num_spks=3,
            activate="relu", causal=False, n_src=3, sample_rate=16000)
SR = 16000
CSRC = "audio_only_speech_separation_tpu_torch/csrc/"
PALLAS = "audio_only_speech_separation_tpu/ops/pallas/"
TRAIN_B = 12  # configs/convtasnet_lrs3.yml datamodule batch_size
# configs/dptnet_wsj0.yml and configs/dprnn_wsj0.yml audionet_config (they
# differ only in ``module``), written out; 8 kHz
WSJ0_TASNET = dict(enc_dim=64, bn_dim=64, hidden_dim=128, win=16, layer=6, num_spk=2,
                   group_size=1, block_size=100, unfold=False, sample_rate=8000)
TSR = 8000
# configs/sepformer_base.yml audionet_config, written out; 16 kHz
SEPFORMER = dict(encoder_kernel_size=16, encoder_in_nchannels=1, encoder_out_nchannels=256,
                 masknet_chunksize=250, masknet_numlayers=2, masknet_norm="gLN", masknet_numspks=2,
                 intra_numlayers=8, inter_numlayers=8, intra_nhead=8, inter_nhead=8, intra_dffn=1024,
                 inter_dffn=1024, intra_use_positional=True, inter_use_positional=True,
                 intra_norm_before=True, inter_norm_before=True, intra_causal=False, inter_causal=False)
SEPFORMER_K4 = 2 * (8 + 8)  # K4 launches a call: 2 dual blocks x (8 intra + 8 inter) attentions
# K4's [BH, dh, T] at B=2 x 2 s x 16 kHz: L = 3999 frames, S = 34 chunks of K = 250, h = 8, dh = 32
SEPFORMER_SHAPES = {"intra": (2 * 34 * 8, 32, 250), "inter": (2 * 250 * 8, 32, 34)}
# configs/bsrnn_wsj0.yml audionet_config, written out; 8 kHz (8 bands)
BSRNN_WSJ0 = dict(win=256, stride=64, feature_dim=128, num_spks=2, num_layer=1, num_repeat=8, context=0,
                  dropout=0.0, bi_comm=True)
BSRNN_LAUNCHES = 8  # K5 and K6 each a BSRNN call: one band RNN and one band-comm RNN a repeat


def bsrnn_shapes(batch: int):
    """K5's (T, D, B, H) and K6's (T, B, Din, H, D) in a BSRNN call at
    B=batch x 4 s x 8 kHz: T' = 501 frames, 8 bands, BiLSTMs of H 256."""
    return (501, 2, 8 * batch, 256), (8, 501 * batch, 128, 256, 2)


# configs/tdanet_lrs2.yml and configs/afrcnn_lrs2.yml audionet_config, written out; 16 kHz
TDANET_LRS2 = dict(out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=5, enc_kernel_size=4,
                   num_sources=2)
AFRCNN_LRS2 = dict(out_channels=512, in_channels=512, num_blocks=16, upsampling_depth=5, enc_kernel_size=1,
                   num_sources=2)
TDANET_K4 = 16  # K4 launches a module-path TDANet call: one global attention a block
# K4's [T_deep * 8 heads, dh 64, B] in TDANet at B x 2 s x 16 kHz: T' 2010 -> 1005 -> 503 -> 252 -> 126
TDANET_K4_SHAPE = (126 * 8, 64)
# utterances of the eval CLI phase, seconds
EVAL_SECONDS = (1.3, 2.0, 4.0, 6.5, 8.0)
# Sandglasset at its constructor defaults (models/sandglasset.py), 8 kHz as
# scripts/bench_all.py:39 runs it: 2 s give 16002 frames, S = 131 chunks of
# K = 250, D 128, 8 heads of dh 16, 6 blocks pooling 1, 4, 16, 16, 4, 1
SANDGLASSET = dict(n_feats=64, bn_chan=128, hid_size=128, chunk_size=250, hop_size=125, n_repeats=6,
                   n_head=8, kernel_size=2)
SANDGLASSET_LAUNCHES = (6, 0, 6)  # K4, K5, K6 a call: one attention and one intra BiLSTM a block


def sandglasset_shapes(batch: int):
    """K4's [BH, dh, T] by block pair and K6's (T, B, Din, H, D) in a
    Sandglasset call at B=batch x 2 s x 8 kHz: blocks 0/5 attend over the
    131 chunks with the 250 positions batched, 1/4 with 62 pooled, 2/3 15."""
    k4 = {"blocks 0/5": (batch * 250 * 8, 16, 131), "blocks 1/4": (batch * 62 * 8, 16, 131),
          "blocks 2/3": (batch * 15 * 8, 16, 131)}
    return k4, (250, batch * 131, 128, 128, 2)


# DPRNNTasNet at its defaults (models/dprnn_old.py), 8 kHz as
# scripts/bench_all.py:40: win 32 samples, 2006 frames at 2 s, 128 chunks of
# 32 an utterance; rows (B*128 sequences of 32) and columns (B*32 of 128)
DPRNN_TASNET = dict(feature_dim=128, hidden_dim=256, win=4, layer=6, segment_size=32)
DPRNN_TASNET_LAUNCHES = {1: (0, 12, 0), 8: (0, 0, 12)}  # K4, K5, K6 a call: 128 and 32 / 1024 and 256 sequences
DPRNN_TASNET_K5 = ((32, 2, 128, 256), (128, 2, 32, 256))  # (T, D, B, H) at B=1: rows, columns
DPRNN_TASNET_K6 = ((32, 1024, 128, 256, 2), (128, 256, 128, 256, 2))  # (T, B, Din, H, D) at B=8
# The other TasNet separator modules at the wsj0 widths (module swapped),
# with group size 2 where they communicate, and the K4, K5, K6 launches of
# a call at B=8 x 2 s x 8 kHz: the context GC_RNNs (4 layers over 8 x 168
# windows x 2 groups: K6), the grouped cores' rows (96 sequences: K5) and
# columns (1600: K6), DPTNet's attention (dh 8: K4); TCN and SudoRM-RF none
TASNET_MODULES = {"TCN": (1, (0, 0, 0)), "SudoRMRF": (1, (0, 0, 0)), "GC_TCN": (2, (0, 0, 4)),
                  "GC_SudoRMRF": (2, (0, 0, 4)), "DPRNN G2": (2, (0, 6, 10)), "DPTNet G2": (2, (12, 6, 10))}
PEAK_FLOPS = 989e12  # H100 SXM bf16 dense tensor-core peak, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


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


def rel_l2(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.float(), got.float()
    return float((ref - got).norm() / (ref.norm() + 1e-9))


def cuda_time(fn, reps: int, warmup: int = 2):
    """Median ms of ``fn`` over ``reps`` calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def chain_inputs(dev, nb, H, B, T, seed):
    """Random packed chain weights in the JAX validator's distribution
    (scripts/validate_pallas.py:399-418), an input and a cotangent."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    x = t(rng.normal(size=(B, T, 128)), bf)
    vecs = rng.normal(size=(nb, 8, H)) * 0.3
    vecs[:, 7] = 0.0
    w = (t(rng.normal(size=(nb, 128, H)) * 0.1, bf), t(rng.normal(size=(nb, H, 128)) * 0.1, bf),
         t(vecs), t(rng.normal(size=(nb, 2, 128)) * 0.1),
         t(np.abs(rng.normal(size=(nb, 2))) * 0.3 + 0.05))
    g = t(rng.normal(size=(B, T, 128)), bf)
    return x, w, tuple(2 ** (i % 8) for i in range(nb)), g


def write_wav(path: str, data: np.ndarray, sr: int = SR) -> None:
    """float32 in [-1, 1] -> mono PCM16 at ``sr``."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(data, -1.0, 1.0) * 32767.0).astype("<i2").tobytes())


def train_frames(T: int, L: int = 16) -> int:
    """T' of the model's framing for T samples (models/convtasnet.py::_pads)."""
    win, pad_stride = L, L // 2
    rest = win - (pad_stride + T % win) % win
    return (T + rest + 2 * (win - pad_stride) - win) // (L // 4) + 1


def write_manifests(root: str, lengths_per_split, seed: int, mix: str = "mix_noise", n_src: int = 3,
                    sr: int = SR) -> None:
    """Synthetic manifests (``<mix>.json``, s1.json ..., lists of [wav path,
    samples]) of random speakers and their sum; ``lengths_per_split`` maps
    each split to its utterances' lengths in samples.  The defaults are the
    LRS3 layout (mix_noise, 3 speakers, 16 kHz); LRS2's is mix, 2."""
    rng = np.random.default_rng(seed)
    for split, lengths in lengths_per_split.items():
        infos = {c: [] for c in (mix, *(f"s{j + 1}" for j in range(n_src)))}
        for c in infos:
            os.makedirs(os.path.join(root, split, c), exist_ok=True)
        for i, n in enumerate(lengths):
            srcs = (0.1 * rng.standard_normal((n_src, n))).astype(np.float32)
            for c, wav in zip(infos, (srcs.sum(0), *srcs)):
                path = os.path.join(root, split, c, f"u{i}.wav")
                write_wav(path, wav, sr)
                infos[c].append([path, n])
        for c, lst in infos.items():
            with open(os.path.join(root, split, f"{c}.json"), "w") as f:
                json.dump(lst, f)


def lrs3_train_config(data_root: str, epochs: int) -> dict:
    """configs/convtasnet_lrs3.yml, written out (no YAML reader needed), with
    the data dirs under data_root, ``epochs`` epochs and the bf16 kernel path."""
    return {
        "audionet": {"audionet_name": "ConvTasNet",
                     "audionet_config": {k: v for k, v in LRS3.items() if k != "sample_rate"}},
        "loss": {
            "train": {"loss_func": "PITLossWrapper", "sdr_type": "pairwise_neg_snr",
                      "config": {"pit_from": "pw_mtx", "threshold_byloss": True}},
            "val": {"loss_func": "PITLossWrapper", "sdr_type": "pairwise_neg_sisdr",
                    "config": {"pit_from": "pw_mtx", "threshold_byloss": False}},
        },
        "training": {"system": "AudioLightningModule", "epochs": epochs,
                     "precision": "bfloat16", "fused_forward": True,
                     "early_stop": {"monitor": "val_loss/dataloader_idx_0", "mode": "min",
                                    "patience": 10, "verbose": True}},
        "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"sche_name": "ReduceLROnPlateau", "sche_config": {"patience": 5, "factor": 0.5}},
        "datamodule": {"data_name": "LRS3DataModule", "data_config": {
            "train_dir": os.path.join(data_root, "tr"), "valid_dir": os.path.join(data_root, "cv"),
            "test_dir": os.path.join(data_root, "tt"), "n_src": 3, "sample_rate": SR, "fps": 25,
            "segment": 2.0, "normalize_audio": False, "batch_size": TRAIN_B, "num_workers": 8,
            "pin_memory": True, "persistent_workers": False, "audio_only": True}},
        "exp": {"exp_name": "ConvTasNet-LRS33SPK-smoke"},
    }


def profile_kernels(fn, calls: int) -> dict:
    """{kernel name: (device ms, launches) per call of ``fn``} under
    torch.profiler, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0],
             e.self_device_time_total / 1e3 / calls, e.count / calls)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: (ms, n) for k, ms, n in sorted(rows, key=lambda r: -r[1])}


def launch_ms(fn, prefix: str, calls: int = 5):
    """Device ms of one launch of the kernels whose names start with
    ``prefix``, under torch.profiler: their time over the launches the
    trace holds (a trace can miss launches, so not over the calls); None
    where it holds none."""
    rows = [(ms, n) for k, (ms, n) in profile_kernels(fn, calls).items() if k.startswith(prefix)]
    launches = sum(n for _, n in rows)
    return sum(ms for ms, _ in rows) / launches if launches else None


def traced_per_step(device_ms, T: int) -> str:
    """``launch_ms``'s reading of a recurrence over T steps, as printed."""
    if device_ms is None:
        return "not traced on the device (torch.profiler)"
    return f"{device_ms:.4f} ms a launch on the device (torch.profiler), {device_ms / T * 1e3:.3f} us a step"


def back_to_back_ms(fn, n: int = 50) -> float:
    """CUDA-event ms of ``n`` calls of ``fn`` issued back to back, over n:
    the device time of one where the host issues faster than the device
    runs."""
    return cuda_time(lambda: [fn() for _ in range(n)], reps=5, warmup=1) / n


def lstm_library_ms(dev, x, Din: int, H: int):
    """bf16 ``nn.LSTM(Din, H, bidirectional)`` on x [B, T, Din], back to
    back, or None where the installed PyTorch has no bf16 LSTM here."""
    lstm = torch.nn.LSTM(Din, H, batch_first=True, bidirectional=True).to(dev, torch.bfloat16)
    lstm.flatten_parameters()
    try:
        with torch.no_grad():
            return back_to_back_ms(lambda: lstm(x), 10)
    except RuntimeError as e:
        print(f"  nn.LSTM in bf16 not timed: {e}")
        return None


def least_time(nbytes: float, flops: float):
    """(least ms the card could take, "bytes" or "operations"): the larger of
    the bytes over HBM bandwidth and the tensor-core FLOPs over the bf16
    peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def separator_work(B, T, N=512, C=128, nb=24, spk=3, win=16):
    """(bytes, FLOPs) of the whole separator (K1) on [B, T', win] frames:
    frames in and decoder frames out once, the weights once; the products
    of the encoder, bottleneck, nb blocks (two 1x1s each), mask head and
    decoder, and the depthwise taps."""
    flops = B * T * (2 * win * N + 2 * N * C + nb * (2 * 2 * C * N + 6 * N)
                     + 2 * C * spk * N + 2 * spk * N * win)
    weights = (nb + 1) * (2 * C * N * 2 + 8 * N * 4 + 2 * C * 4 + 8) + 2 * win * N * 2 + C * spk * N * 6
    return B * T * win * 2 * (1 + spk) + weights, flops


def separator_design_bytes(B, T, N=512, C=128, nb=24, spk=3, win=16):
    """Device-memory bytes the K1 design moves a call: the encoder reads the
    frames and writes enc (bf16) and P (f32); each block's P1 reads y and P
    and writes y, its P2 reads y (its halo counted once) and writes P; the
    head reads y, P and enc and writes the decoder frames; the weights
    once.  No hidden state: h never reaches device memory."""
    rows = B * (-(-T // 64) * 64)
    weights = separator_work(B, T, N, C, nb, spk, win)[0] - B * T * win * 2 * (1 + spk)
    return (B * T * win * 2 + rows * (N * 2 + C * 4) + nb * rows * C * (2 + 4 + 2 + 2 + 4)
            + rows * (C * 2 + C * 4 + N * 2) + B * spk * T * win * 2 + weights)


def chain_design_bytes(B, T, nb=24, H=512, C=128):
    """Device-memory bytes the K2 design moves a call: per block P1 reads y
    and P and writes the next y_hist slot, P2 reads that slot (its halo
    counted once) and writes P; the epilogue reads the last y and P and
    writes y; the weights once."""
    rows = B * (-(-T // 64) * 64)
    weights = nb * (2 * C * H * 2 + 8 * H * 4 + 2 * C * 4 + 8)
    return nb * rows * C * (2 + 4 + 2 + 2 + 4) + rows * C * (2 + 4) + B * T * C * 2 + B * nb * 16 + weights


def print_kernels(label: str, kernels: dict, launches: int, design_bytes: float, work, card: str) -> None:
    """One line of a profile_kernels breakdown, then the design's device
    bytes beside the function's least time."""
    print(f"  {label} by kernel (torch.profiler, per call of {launches} launches, {card}): "
          + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:g} launches)" for k, v in kernels.items()))
    bound, by = least_time(*work)
    print(f"  {label} design moves {design_bytes / 1e9:.4f} GB of device memory a call "
          f"({design_bytes / PEAK_BYTES * 1e3:.4f} ms at 3.35 TB/s); the function's least time "
          f"{bound:.4f} ms ({by})")


def chain_work(B, T, nb=24, H=512, C=128, products=2):
    """(bytes, FLOPs) of the TCN chain forward (K2, 2 products a block) or
    backward (K3, 5: the recomputed 1x1, two input gradients, two weight
    gradients): x and the cotangent or y in, y / dx and y_hist out once."""
    tpad = -(-T // 64) * 64
    weights = nb * (2 * C * H * 2 + 8 * H * 4 + 2 * C * 4 + 8)
    nbytes = 2 * B * T * C * 2 + B * nb * tpad * C * 2 + B * nb * 16 + weights * (1 if products == 2 else 2)
    return nbytes, B * T * nb * (products * 2 * C * H + 6 * H)


def tasnet_model(module: str, seed: int, dev):
    """A wsj0 TasNet (``module`` core) at full width and depth with seeded
    weights: the seeded init, with the norm affines and biases redrawn."""
    from audio_only_speech_separation_tpu_torch.models import TasNet

    m = TasNet(**WSJ0_TASNET, module=module, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if ("norm" in name or name.startswith("bottleneck.0")) and p.ndim == 1:
                p.add_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    return m.to(dev).eval()


def rand_maker(seed: int, dev):
    """rand(shape, scale, dtype): seeded normal tensors on ``dev``."""
    rng = np.random.default_rng(seed)

    def rand(shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)

    return rand


def kernel_vs_plain(label, kernel, plain, args, limit) -> float:
    """``kernel`` against ``plain`` on ``args``: two kernel runs
    bit-identical and finite, max abs error below ``limit``; returns it."""
    with torch.no_grad():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, again) or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{label}: two kernel runs differ or the output is not finite")
    err = max_err(got, want)
    print(f"  {label}: max abs {err:.6g} (bound {limit:g})")
    if not err < limit:
        raise AssertionError(f"{label}: kernel vs plain max abs {err} >= {limit}")
    return err


def dualpath_kernel_checks(dev):
    """Phases 10-13: K4, K5 and K6 against their plain versions, forward at
    the listed shapes and one backward each; returns their worst forward
    max abs errors."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        resident_bilstm,
        resident_bilstm_reference,
    )

    rand = rand_maker(20, dev)
    against_plain = kernel_vs_plain

    print("phase 10: K4 (attention) vs plain, unit-normal bf16 q, k, v")
    k4_err = max(
        against_plain(f"[BH, dh, T] = {list(s)}", fused_attention_bdt, attention_bdt_reference,
                      [rand(s) for _ in range(3)], 2e-2)
        # the validator's (scripts/validate_pallas.py:183), then DPTNet's rows
        # and columns at B=8 x 2 s and at B=1 x 12 s; then the kernel's edges:
        # T on either side of a 16-query tile, several 128-key chunks, dh 8
        # and 256
        for s in [(512, 32, 250), (528, 32, 250), (64, 32, 100), (16, 64, 129),
                  (1344, 16, 100), (3200, 16, 42), (968, 16, 100), (400, 16, 242),
                  (3, 16, 15), (3, 16, 16), (3, 16, 17), (4, 16, 300), (6, 8, 50), (3, 256, 40),
                  (2, 256, 300)])

    print("phase 11: K5 (LSTM recurrence) vs plain, xw * 0.3, w_hh * 0.05")
    k5_err = max(
        against_plain(f"(T, D, B, H) = {(T, D, B, H)}", fused_bilstm, bilstm_reference,
                      [rand((T, D, B, 4 * H), 0.3), rand((D, H, 4 * H), 0.05)], 1e-2)
        # the validator's, the batch-1 12 s column pass; then the kernel's
        # edges: T = 1, a partial 16-row tile, B 100 with a short T, H 48 (a
        # cluster of 2) and 256 at B 2, and one block a tile (B 1100)
        for T, D, B, H in [(251, 2, 64, 256), (250, 2, 96, 128), (128, 1, 32, 128), (242, 2, 100, 128),
                           (1, 2, 4, 32), (6, 2, 17, 16), (5, 2, 100, 128), (40, 2, 3, 48),
                           (4, 1, 2, 256), (3, 2, 1100, 128)])

    print("phase 12: K6 (resident LSTM) vs plain, x * 0.5, w_ih * 0.08, w_hh * 0.05, bias * 0.05")
    k6_err = max(
        against_plain(f"(T, B, Din, H, D) = {(T, B, Din, H, D)}", resident_bilstm,
                      resident_bilstm_reference,
                      [rand((B, T, Din), 0.5), rand((D, Din, 4 * H), 0.08), rand((D, H, 4 * H), 0.05),
                       rand((D, 4 * H), 0.05, torch.float32)], 1e-2)
        for T, B, Din, H, D in [(100, 336, 64, 128, 2), (42, 800, 64, 128, 2), (250, 256, 128, 128, 2),
                                (40, 800, 64, 128, 1), (100, 241, 64, 128, 2), (1, 40, 64, 128, 2),
                                (20, 50, 128, 256, 2)])

    print("phase 13: backward through K4, K5, K6 vs autograd of the plain version (rel-l2 < 2e-2)")

    def backward_check(label, kernel, plain, inputs):
        leaves = [a.clone().requires_grad_() for a in inputs]
        ref = [a.clone().requires_grad_() for a in inputs]
        out_k, out_p = kernel(*leaves), plain(*ref)
        g = rand(tuple(out_p.shape), 1.0, out_p.dtype)
        rels = [rel_l2(b, a) for a, b in zip(torch.autograd.grad(out_k, leaves, g),
                                              torch.autograd.grad(out_p, ref, g))]
        print(f"  {label}: rel-l2 " + ", ".join(f"{r:.4g}" for r in rels))
        if not max(rels) < 2e-2:
            raise AssertionError(f"{label} backward: rel-l2 {rels}")

    backward_check("K4 [64, 16, 100]", fused_attention_bdt, attention_bdt_reference,
                   [rand((64, 16, 100)) for _ in range(3)])
    backward_check("K5 (40, 2, 24, 128)", fused_bilstm, bilstm_reference,
                   [rand((40, 2, 24, 512), 0.3), rand((2, 128, 512), 0.05)])
    backward_check("K6 (30, 150, 64, 128, 2)", resident_bilstm, resident_bilstm_reference,
                   [rand((150, 30, 64), 0.5), rand((2, 64, 512), 0.08), rand((2, 128, 512), 0.05),
                    rand((2, 512), 0.05, torch.float32)])
    return k4_err, k5_err, k6_err


def dualpath_paths(model):
    """(kernel path, plain bf16 path, f32 module) of a model that ``serve``
    serves as "kernels" (a bf16 copy of the module in eval mode): the
    second is the same inside ``plain_versions()``."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.serve import Server

    server = Server(model, True, next(model.parameters()).device)
    if server.dispatch != "kernels":
        raise AssertionError(f"{type(model).__name__}: dispatch {server.dispatch!r}, not 'kernels'")

    def kernel(x):
        return server.forward(x)

    def plain(x):
        with plain_versions():
            return server.forward(x)

    def f32(x):
        with torch.no_grad():
            return model(x)

    return kernel, plain, f32


def tasnet_serving(dev, tasnets):
    """Phases 14-15: each model end to end against the f32 module, then five
    requests served from its checkpoint; returns the launches of K4, K5 and
    K6 while serving."""
    from audio_only_speech_separation_tpu_torch.models import from_pretrain, save_serialized, serialize
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import fused_attention_bdt
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import fused_bilstm, resident_bilstm
    from audio_only_speech_separation_tpu_torch.serve import serve

    print("phase 14: DPTNet and DPRNN (wsj0 configs, 8 kHz), kernel path vs plain bf16 vs f32")
    for name, model in tasnets.items():
        kernel, plain, f32 = dualpath_paths(model)
        for batch, secs in ((2, 2.0), (1, 12.0)):
            x = torch.from_numpy(np.random.default_rng(23).standard_normal(
                (batch, int(secs * TSR))).astype(np.float32)).to(dev)
            ref, got, pl = f32(x), kernel(x), plain(x)
            torch.cuda.synchronize()
            for out in (got, pl):
                if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                    raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
            print(f"  {name} B={batch} x {secs} s (output scale {float(ref.abs().max()):.4g}):")
            check_rule(f"{name} B={batch} x {secs} s", max_err(got, ref), max_err(pl, ref))

    print("phase 15: serve 5 requests per model from a checkpoint (bf16, batch 1, 1 s buckets)")
    req_rng = np.random.default_rng(24)
    wavs = [req_rng.standard_normal(int(s * TSR)).astype(np.float32) for s in (1.3, 2.0, 4.0, 7.5, 12.0)]
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, model in tasnets.items():
            ckpt = os.path.join(tmp, f"{name}.pth")
            save_serialized(serialize(model), ckpt)
            served[name] = from_pretrain(ckpt, device=dev).eval()
    counters = (fused_attention_bdt, fused_bilstm, resident_bilstm)
    for c in counters:
        c.launches = 0
    estimates, per_model = {}, {}
    for name, model in served.items():
        before = [c.launches for c in counters]
        estimates[name] = serve(model, wavs, use_bf16=True, device=dev, bucket_seconds=1.0, batch_size=1)
        torch.cuda.synchronize()
        per_model[name] = [c.launches - b for c, b in zip(counters, before)]
    launches = [c.launches for c in counters]
    for name, (n4, n5, n6) in per_model.items():
        print(f"  {name}: launches K4 {n4}, K5 {n5}, K6 {n6}")
    if not (per_model["DPTNet"][0] > 0 and launches[1] > 0 and launches[2] > 0):
        raise AssertionError(f"serving did not launch K4, K5 and K6: {per_model}")
    for name, model in served.items():
        ref = serve(model, wavs, use_bf16=False, device=dev, bucket_seconds=1.0, batch_size=1)
        with plain_versions():
            plain = serve(model, wavs, use_bf16=True, device=dev, bucket_seconds=1.0, batch_size=1)
        for i, wav in enumerate(wavs):
            est = estimates[name][i]
            if est.shape != (2, len(wav)) or not np.isfinite(est).all():
                raise AssertionError(f"{name} request {i}: bad estimate {est.shape}")
            check_rule(f"{name} request {i} ({len(wav) / TSR:.1f} s)", float(np.abs(est - ref[i]).max()),
                       float(np.abs(plain[i] - ref[i]).max()))
    return tuple(launches)


LIBRARY_GEMMS = ("gemm", "xmma", "nvjet", "cutlass")  # kernel names of cuBLAS/CUTLASS matmuls


def in_turns(runs: dict, reps: int) -> dict:
    """Median ms of each of ``runs`` (name -> function), CUDA events around
    each call, the functions timed in turns after two warm-up calls each."""
    for fn in runs.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in runs}
    for _ in range(reps):  # in turns
        for name, fn in runs.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {k: statistics.median(v) for k, v in times.items()}


def device_profile(label: str, fn, call_ms: float, counters, card: str, calls: int = 5,
                   cpu: bool = True) -> dict:
    """``fn`` under torch.profiler: each of ``counters`` (label, wrapper,
    kernel name) by device time and launches a call, the library matmuls,
    the rest (the plain ops), all device work and its device operations a
    call (kernels, copies, memsets), the idle share (against
    ``call_ms``, the unprofiled time), and the largest kernels by name.
    ``cpu`` False traces the device alone, for calls of many operations.
    Returns {"K…", "matmuls", "busy", "wall"} in ms a call."""
    from torch.profiler import ProfilerActivity, profile

    for _, c, _ in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    dev_us = {g: 0.0 for g, _, _ in counters}
    busy_us = gemm_us = 0.0
    ops = 0
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += evt.self_device_time_total
        ops += evt.count
        by_name[evt.key.split("(")[0][:60]] = evt.self_device_time_total / 1e3 / calls
        if any(g in evt.key.lower() for g in LIBRARY_GEMMS):
            gemm_us += evt.self_device_time_total
        for g, _, key in counters:
            if key in evt.key:
                dev_us[g] += evt.self_device_time_total
    busy_ms, gemm_ms = busy_us / 1e3 / calls, gemm_us / 1e3 / calls
    prof_ms = {g: dev_us[g] / 1e3 / calls for g in dev_us}
    print(f"  {label} under torch.profiler, per call: " + "".join(
        f"{g} {prof_ms[g]:.4f} ms device, {c.launches / calls:g} launches; " for g, c, _ in counters)
        + f"library matmuls {gemm_ms:.4f} ms; the rest {busy_ms - gemm_ms - sum(prof_ms.values()):.4f} ms"
        f"; all device work {busy_ms:.4f} ms in {ops / calls:g} device operations (kernels, copies, "
        f"memsets); wall {wall_ms:.4f} ms with the profiler; idle share "
        f"{1 - busy_ms / wall_ms:.4f} (profiler on), {1 - busy_ms / call_ms:.4f} "
        f"(against the unprofiled time); {card}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"  {label} largest kernels (ms a call): " + ", ".join(f"{k} {v:.4f}" for k, v in top))
    return dict(prof_ms, matmuls=gemm_ms, busy=busy_ms, wall=wall_ms)


def time_calls(dev, card, models, batch: int, secs: float, sr: int, reps: int, counters) -> dict:
    """Each model at B=batch x secs s x sr: the kernel path, the plain bf16
    path and the f32 module timed in turns (CUDA events, median of
    ``reps``), then the kernel path under torch.profiler
    (``device_profile``).  Returns {label: ms} with, per model, "<name>
    profile": {"K…", "matmuls", "busy", "wall"} in ms a call."""
    shape = f"B={batch} x {secs:g} s x {sr // 1000} kHz"
    x = torch.from_numpy(np.random.default_rng(25).standard_normal(
        (batch, int(secs * sr))).astype(np.float32)).to(dev)
    runs = {}
    for name, model in models.items():
        kernel, plain, f32 = dualpath_paths(model)
        runs[f"{name} kernel path"] = lambda f=kernel: f(x)
        runs[f"{name} plain bf16 path"] = lambda f=plain: f(x)
        runs[f"{name} f32 module"] = lambda f=f32: f(x)
    ms = in_turns(runs, reps)
    for name, v in ms.items():
        print(f"  {shape}, {name}: {v:.4f} ms/call, {batch * secs / (v / 1000):.2f} audio-sec/s "
              f"(median of {reps}, {card})")
    for name in models:
        ms[f"{name} profile"] = device_profile(f"{shape}, {name} kernel path", runs[f"{name} kernel path"],
                                               ms[f"{name} kernel path"], counters, card)
    return ms


def tasnet_counters():
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import fused_attention_bdt
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import fused_bilstm, resident_bilstm

    return (("K4", fused_attention_bdt, "attention_kernel"), ("K5", fused_bilstm, "lstm_recurrence_kernel"),
            ("K6", resident_bilstm, "lstm_resident_kernel"))


def tasnet_timing(dev, card, tasnets):
    """Phase 16: both models at B=8 x 2 s and B=1 x 12 s x 8 kHz (kernel
    path, plain bf16 path, f32 module, the kernel path profiled), and K4,
    K5 and K6 alone at main-path shapes beside their plain versions and
    PyTorch yardsticks, K5 and K6 also per step with the thread-block
    cluster they take; returns the three kernels' timing entries."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        recurrence_cluster,
        resident_bilstm,
        resident_bilstm_reference,
        resident_cluster,
    )

    print(f"phase 16: timing, B=8 x 2 s and B=1 x 12 s x 8 kHz, on {card}")
    time_calls(dev, card, tasnets, 8, 2.0, TSR, 10, tasnet_counters())
    time_calls(dev, card, tasnets, 1, 12.0, TSR, 5, tasnet_counters())
    rand = rand_maker(26, dev)

    def timed(fn, reps=20):
        with torch.no_grad():
            return cuda_time(fn, reps=reps, warmup=3)

    def lstm_yardstick(x):
        """bf16 nn.LSTM(64, 128, bidirectional) on x, or None where the
        installed PyTorch has no bf16 LSTM on this card."""
        lstm = torch.nn.LSTM(64, 128, batch_first=True, bidirectional=True).to(dev, torch.bfloat16)
        lstm.flatten_parameters()
        try:
            return timed(lambda: lstm(x))
        except RuntimeError as e:
            print(f"  nn.LSTM in bf16 not timed: {e}")
            return None

    print(f"  kernels alone at main-path shapes (median of 20, CUDA events, {card}):")
    q, k, v = (rand((1344, 16, 100)) for _ in range(3))  # DPTNet rows at B=8 x 2 s
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    k4 = {"ms": timed(lambda: fused_attention_bdt(q, k, v)),
          "plain_ms": timed(lambda: attention_bdt_reference(q, k, v)),
          "library_ms": timed(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))}
    k4["bound_ms"], k4["bound_by"] = least_time(4 * q.numel() * 2, 4 * 1344 * 100 * 100 * 16)
    xw, whh = rand((242, 2, 100, 512), 0.3), rand((2, 128, 512), 0.05)  # batch-1 12 s inter pass
    k5 = {"ms": timed(lambda: fused_bilstm(xw, whh)), "plain_ms": timed(lambda: bilstm_reference(xw, whh), 3),
          "library_ms": None, "yardstick_ms": lstm_yardstick(rand((100, 242, 64), 0.5))}
    k5["bound_ms"], k5["bound_by"] = least_time((xw.numel() + xw.numel() // 4 + whh.numel()) * 2,
                                           2 * 242 * 2 * 100 * 128 * 512)
    x6, wih6, whh6, b6 = (rand((336, 100, 64), 0.5), rand((2, 64, 512), 0.08), rand((2, 128, 512), 0.05),
                          rand((2, 512), 0.05, torch.float32))  # DPRNN rows at B=8 x 2 s
    k6 = {"ms": timed(lambda: resident_bilstm(x6, wih6, whh6, b6)),
          "plain_ms": timed(lambda: resident_bilstm_reference(x6, wih6, whh6, b6), 3),
          "library_ms": lstm_yardstick(x6)}
    k6["bound_ms"], k6["bound_by"] = least_time(
        x6.numel() * 2 + (wih6.numel() + whh6.numel()) * 2 + b6.numel() * 4 + 100 * 2 * 336 * 128 * 2,
        2 * 100 * 2 * 336 * (64 + 128) * 512)
    for label, d in (("K4 [1344, 16, 100], SDPA beside it", k4),
                     ("K5 (242, 2, 100, 128), nn.LSTM on [100, 242, 64] as a yardstick", k5),
                     ("K6 (100, 336, 64, 128, 2), nn.LSTM beside it", k6)):
        print(f"  {label}: " + ", ".join(f"{key} {val:.6g}" if isinstance(val, float) else f"{key} {val}"
                                          for key, val in d.items()))
    with torch.no_grad():
        k5_dev = launch_ms(lambda: fused_bilstm(xw, whh), "lstm_recurrence_kernel")
    print(f"  K5 (T=242, D=2, B=100, H=128): the kernel {traced_per_step(k5_dev, 242)}, "
          f"cluster of {recurrence_cluster(100, 2, 128)}")
    for label, T, B in (("rows", 100, 336), ("DPRNN columns", 42, 800), ("batch-1 rows", 100, 242),
                        ("K5's batch-1 columns", 242, 100)):
        x = rand((B, T, 64), 0.5)
        lib = lstm_yardstick(x)
        with torch.no_grad():
            dev_ms = launch_ms(lambda: resident_bilstm(x, wih6, whh6, b6), "lstm_resident_kernel")
        print(f"  K6 {label} (T={T}, B={B}): {timed(lambda: resident_bilstm(x, wih6, whh6, b6)):.4f} ms a call; "
              f"the kernel {traced_per_step(dev_ms, T)}, cluster of {resident_cluster(B, 2, 64, 128)}; nn.LSTM "
              + ("not timed" if lib is None else f"{lib:.4f} ms"))
    qc, kc, vc = (rand((3200, 16, 42)) for _ in range(3))
    print(f"  K4 DPTNet columns [3200, 16, 42]: {timed(lambda: fused_attention_bdt(qc, kc, vc)):.4f} ms")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return k4, k5, k6


def sepformer_model(seed: int, dev):
    """sepformer_base at full width and depth with seeded weights: the
    seeded init, with the norm affines redrawn."""
    from audio_only_speech_separation_tpu_torch.models import Sepformer

    m = Sepformer(**SEPFORMER, sample_rate=SR, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "norm" in name and p.ndim == 1:
                p.add_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    return m.to(dev).eval()


def sepformer_checks(dev, model) -> float:
    """Phase 17: the Sepformer end to end at B=2 x 2 s and B=1 x 8 s (kernel
    path through ``serve``'s dispatch, plain bf16 path, f32 module) under
    the 1.5x rule, with exactly SEPFORMER_K4 K4 launches a call; then K4
    against its plain version at the two shapes of B=2 x 2 s.  Returns
    K4's worst max abs error there."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )

    print("phase 17: Sepformer (sepformer_base, 16 kHz, full width and depth), kernel path vs plain bf16 vs f32")
    kernel, plain, f32 = dualpath_paths(model)
    for batch, secs in ((2, 2.0), (1, 8.0)):
        x = torch.from_numpy(np.random.default_rng(28).standard_normal(
            (batch, int(secs * SR))).astype(np.float32)).to(dev)
        fused_attention_bdt.launches = 0
        got = kernel(x)
        torch.cuda.synchronize()
        launches = fused_attention_bdt.launches
        ref, pl = f32(x), plain(x)
        torch.cuda.synchronize()
        for out in (got, pl):
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                raise AssertionError(f"Sepformer: bad output {tuple(out.shape)}")
        print(f"  Sepformer B={batch} x {secs:g} s (output scale {float(ref.abs().max()):.4g}): "
              f"K4 launches {launches} (want {SEPFORMER_K4})")
        if launches != SEPFORMER_K4:
            raise AssertionError(f"Sepformer launched K4 {launches} times, not {SEPFORMER_K4}")
        check_rule(f"Sepformer B={batch} x {secs:g} s", max_err(got, ref), max_err(pl, ref))
    rand = rand_maker(29, dev)
    print("  K4 vs plain at Sepformer's shapes, unit-normal bf16 q, k, v")
    return max(kernel_vs_plain(f"{side} [BH, dh, T] = {list(shape)}", fused_attention_bdt,
                               attention_bdt_reference, [rand(shape) for _ in range(3)], 2e-2)
               for side, shape in SEPFORMER_SHAPES.items())


def eval_cli_checks(dev, root: str, title: str, experiments: dict) -> dict:
    """``audio_test.main(config, device="cuda")`` with --bf16 on each of
    ``experiments`` (label -> (exp_dir or None to write ``model``'s
    checkpoint, model, audionet config, data module, n_src, sample rate,
    kernels that must launch, kernels that must not, the dispatch)), each
    on EVAL_SECONDS utterances.  Each CSV has a row per utterance plus avg
    and std, every value finite, and equals within 1e-3 dB what
    ``MetricsTracker`` gives on ``serve()``'s estimates of the same model
    with the same dispatch.  Returns {experiment: {kernel: launches during
    its CLI run}}."""
    from audio_only_speech_separation_tpu_torch import audio_test
    from audio_only_speech_separation_tpu_torch import data as datas
    from audio_only_speech_separation_tpu_torch.metrics import MetricsTracker
    from audio_only_speech_separation_tpu_torch.models import from_pretrain, save_serialized, serialize
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import fused_convtasnet_separator
    from audio_only_speech_separation_tpu_torch.serve import Server, serve

    print(f"{title} (--bf16, batch 1, 1 s buckets), {len(EVAL_SECONDS)} utterances of "
          f"{EVAL_SECONDS[0]}-{EVAL_SECONDS[-1]} s each")
    counters = {"K1": fused_convtasnet_separator, **{g: c for g, c, _ in tasnet_counters()}}
    launched = {}
    for label, (exp_dir, model, audionet, data_name, n_src, sr, wanted, absent, dispatch) in experiments.items():
        work = tempfile.mkdtemp(prefix="eval_", dir=root)
        if exp_dir is None:
            exp_dir = os.path.join(work, "exp")
            os.makedirs(exp_dir)
            save_serialized(serialize(model), os.path.join(exp_dir, "best_model.pth"))
        data_dir = os.path.join(work, "data")
        write_manifests(data_dir, {"tt": [int(s * sr) for s in EVAL_SECONDS]}, 40 + len(launched),
                        mix="mix_noise" if n_src == 3 else "mix", n_src=n_src, sr=sr)
        tt = os.path.join(data_dir, "tt")
        config = {"audionet": audionet,
                  "datamodule": {"data_name": data_name, "data_config": {
                      "train_dir": tt, "valid_dir": tt, "test_dir": tt, "n_src": n_src, "sample_rate": sr,
                      "segment": 2.0}},
                  "main_args": {"exp_dir": exp_dir, "bf16": True}}
        for c in counters.values():
            c.launches = 0
        csv_path = audio_test.main(config, device="cuda")
        torch.cuda.synchronize()
        launched[label] = {g: c.launches for g, c in counters.items()}
        with open(csv_path) as f:
            rows = [line.split(",") for line in f.read().splitlines()]
        # the tracker on serve()'s estimates of the same model, in the CLI's order
        model = from_pretrain(os.path.join(exp_dir, "best_model.pth"), dev, sample_rate=sr,
                              **audionet["audionet_config"])
        served_by = Server(model, True, dev).dispatch
        test_set = datas.get(data_name)(**dict(config["datamodule"]["data_config"], segment=None))
        test_set.setup()
        test_set = test_set.make_sets[2]
        order = sorted(range(len(test_set)), key=lambda j: test_set.mix[j][1])
        items = [test_set[j] for j in order]
        ests = serve(model, [mix for mix, _, _ in items], use_bf16=True, device=dev)
        ref_csv = os.path.join(work, "ref.csv")
        tracker = MetricsTracker(save_file=ref_csv, sample_rate=sr)
        for (mix, sources, key), est in zip(items, ests):
            tracker(mix, sources, est, key)
        tracker.final()
        with open(ref_csv) as f:
            want = [line.split(",") for line in f.read().splitlines()]
        values = np.array([r[1:] for r in rows[1:]], float)
        diff = float(np.abs(values - np.array([r[1:] for r in want[1:]], float)).max())
        print(f"  {label}: dispatch {served_by}; {len(rows) - 3} rows + avg + std, mean si-snr_i "
              f"{float(values[-2, 3]):.4f} dB; max |CLI - tracker on serve()| {diff:.3g} dB; launches "
              + (", ".join(f"{g} {n}" for g, n in launched[label].items() if n) or "none"))
        if served_by != dispatch:
            raise AssertionError(f"{label}: dispatch {served_by!r}, not {dispatch!r}")
        if (len(rows) != len(EVAL_SECONDS) + 3 or [r[0] for r in rows[-2:]] != ["avg", "std"]
                or not np.isfinite(values).all()):
            raise AssertionError(f"{label}: malformed metrics.csv {rows}")
        if [r[0] for r in rows] != [r[0] for r in want] or not diff <= 1e-3:
            raise AssertionError(f"{label}: CLI rows differ from the tracker on serve() by {diff} dB")
        if not all(launched[label][g] > 0 for g in wanted) or any(launched[label][g] for g in absent):
            raise AssertionError(f"{label}: the eval CLI launched {launched[label]}, wanted {wanted} "
                                 f"and none of {absent}")
    return launched


def sepformer_timing(dev, card, model) -> dict:
    """Phase 19: the Sepformer at B=2 x 2 s x 16 kHz (the JAX package's
    Sepformer row): kernel path, plain bf16 path, f32 module, the kernel
    path profiled; then K4 alone at the intra and inter shapes beside its
    plain version, SDPA on [B, h, T, dh] and its bound.  Returns K4's
    entries by side."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )

    print(f"phase 19: timing, Sepformer at B=2 x 2 s x 16 kHz, on {card}")
    ms = time_calls(dev, card, {"Sepformer": model}, 2, 2.0, SR, 10, tasnet_counters()[:1])
    prof = ms["Sepformer profile"]
    print(f"  Sepformer kernel path, device work a call: K4 {prof['K4']:.4f} ms "
          f"({prof['K4'] / prof['busy']:.4f} of it), library matmuls {prof['matmuls']:.4f} ms "
          f"({prof['matmuls'] / prof['busy']:.4f}), the rest {prof['busy'] - prof['K4'] - prof['matmuls']:.4f} ms; "
          f"all {prof['busy']:.4f} ms; {card}")
    rand = rand_maker(30, dev)
    out = {}
    for side, (BH, dh, T) in SEPFORMER_SHAPES.items():
        q, k, v = (rand((BH, dh, T)) for _ in range(3))
        qt, kt, vt = (a.transpose(1, 2).reshape(BH // 8, 8, T, dh).contiguous() for a in (q, k, v))
        with torch.no_grad():
            d = {"ms": back_to_back_ms(lambda: fused_attention_bdt(q, k, v)),
                 "device_ms": launch_ms(lambda: fused_attention_bdt(q, k, v), "attention_kernel", 100),
                 "call_ms": cuda_time(lambda: fused_attention_bdt(q, k, v), reps=20, warmup=3),
                 "plain_ms": back_to_back_ms(lambda: attention_bdt_reference(q, k, v), 10),
                 "library_ms": back_to_back_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))}
        d["bound_ms"], d["bound_by"] = least_time(4 * q.numel() * 2, 4 * BH * T * T * dh)
        traced = "not traced" if d["device_ms"] is None else f"{d['device_ms']:.4f} ms"
        print(f"  K4 {side} [{BH}, {dh}, {T}]: kernel {d['ms']:.4f} ms a launch (CUDA events over 50 back to "
              f"back), {traced} a launch on the device (torch.profiler, 100 calls), a call "
              f"{d['call_ms']:.4f} ms, plain {d['plain_ms']:.4f} ms, SDPA on [{BH // 8}, 8, {T}, {dh}] "
              f"{d['library_ms']:.4f} ms (both back to back), bound {d['bound_ms']:.5f} ms "
              f"({d['bound_by']}); {card}")
        out[side] = d
    return out


def seeded_model(cls, cfg: dict, sr: int, seed: int, dev):
    """``cls(**cfg)`` at full width and depth with seeded weights: the
    seeded init, with every gLN and LayerNorm affine redrawn."""
    from audio_only_speech_separation_tpu_torch.ops.norms import GlobalLayerNorm

    m = cls(**cfg, sample_rate=sr, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (GlobalLayerNorm, torch.nn.LayerNorm)):
                for p in (mod.weight, mod.bias):
                    p.add_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    return m.to(dev).eval()


def lstm_kernel_inputs(rand, k5_shape=None, k6_shape=None):
    """The JAX validator's inputs at K5's (T, D, B, H): xw * 0.3, w_hh *
    0.05; or at K6's (T, B, Din, H, D): x * 0.5, w_ih * 0.08, w_hh * 0.05,
    an f32 bias * 0.05."""
    if k5_shape is not None:
        T, D, B, H = k5_shape
        return [rand((T, D, B, 4 * H), 0.3), rand((D, H, 4 * H), 0.05)]
    T, B, Din, H, D = k6_shape
    return [rand((B, T, Din), 0.5), rand((D, Din, 4 * H), 0.08), rand((D, H, 4 * H), 0.05),
            rand((D, 4 * H), 0.05, torch.float32)]


def bsrnn_checks(dev, model):
    """Phase 20: BSRNN end to end at B=1 and 4 x 4 s (kernel path through
    ``serve``'s dispatch, plain bf16 path, f32 module) under the 1.5x rule,
    exactly BSRNN_LAUNCHES K5 and K6 launches a call; then K5 and K6
    against their plain versions at BSRNN's shapes.  Returns their worst
    max abs errors and the launches of both calls."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        resident_bilstm,
        resident_bilstm_reference,
    )

    print("phase 20: BSRNN (bsrnn_wsj0, 8 kHz, full width and depth), kernel path vs plain bf16 vs f32")
    kernel, plain, f32 = dualpath_paths(model)
    launches = [0, 0]
    for batch in (1, 4):
        x = torch.from_numpy(np.random.default_rng(32).standard_normal(
            (batch, 4 * TSR)).astype(np.float32)).to(dev)
        fused_bilstm.launches = resident_bilstm.launches = 0
        got = kernel(x)
        torch.cuda.synchronize()
        n5, n6 = fused_bilstm.launches, resident_bilstm.launches
        launches = [launches[0] + n5, launches[1] + n6]
        ref, pl = f32(x), plain(x)
        torch.cuda.synchronize()
        for out in (got, pl):
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                raise AssertionError(f"BSRNN: bad output {tuple(out.shape)}")
        print(f"  BSRNN B={batch} x 4 s (output scale {float(ref.abs().max()):.4g}): launches K5 {n5}, "
              f"K6 {n6} (want {BSRNN_LAUNCHES} each)")
        if (n5, n6) != (BSRNN_LAUNCHES, BSRNN_LAUNCHES):
            raise AssertionError(f"BSRNN launched K5 {n5} and K6 {n6} times, not {BSRNN_LAUNCHES} each")
        check_rule(f"BSRNN B={batch} x 4 s", max_err(got, ref), max_err(pl, ref))
    rand = rand_maker(33, dev)
    print("  K5 and K6 vs plain at BSRNN's shapes (B = 1 and 4 x 4 s), the validator's inputs")
    k5_err = max(kernel_vs_plain(f"K5 (T, D, B, H) = {bsrnn_shapes(b)[0]}", fused_bilstm, bilstm_reference,
                                 lstm_kernel_inputs(rand, k5_shape=bsrnn_shapes(b)[0]), 1e-2) for b in (1, 4))
    k6_err = max(kernel_vs_plain(f"K6 (T, B, Din, H, D) = {bsrnn_shapes(b)[1]}", resident_bilstm,
                                 resident_bilstm_reference, lstm_kernel_inputs(rand, k6_shape=bsrnn_shapes(b)[1]),
                                 1e-2) for b in (1, 4))
    return k5_err, k6_err, launches


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, err = ref.double(), got.double() - ref.double()
    return float(10 * torch.log10(ref.square().sum() / err.square().sum().clamp_min(1e-30)))


def tdanet_checks(dev, model):
    """Phase 21: TDANet at B=1 and 2 x 2 s: the module path in bf16 (K4,
    TDANET_K4 launches a call) under the 1.5x rule against the plain bf16
    module and the f32 module; the fast path in bf16 (``serve``'s
    "fast_tdanet", no K4 launch, SNR against the f32 module above 20 dB,
    the bound of the JAX package's tests/test_tdanet_fast.py) and in f32
    (within 1e-4 of the f32 module's scale, the CPU tests' bound); then K4
    against its plain version at TDANet's two shapes.  Returns K4's worst
    max abs error and the module path's launches."""
    import copy

    from audio_only_speech_separation_tpu_torch.models.tdanet import fast_inference_forward
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )
    from audio_only_speech_separation_tpu_torch.serve import Server

    print("phase 21: TDANet (tdanet_lrs2, 16 kHz, full width and depth): module path vs fast path")
    server = Server(model, True, dev)
    if server.dispatch != "fast_tdanet":
        raise AssertionError(f"TDANet: dispatch {server.dispatch!r}, not 'fast_tdanet'")
    module = copy.deepcopy(model).to(torch.bfloat16)  # the module path, as "kernels" would serve it
    launches = 0
    for batch in (1, 2):
        x = torch.from_numpy(np.random.default_rng(34).standard_normal(
            (batch, 2 * SR)).astype(np.float32)).to(dev)
        with torch.no_grad():
            fused_attention_bdt.launches = 0
            got = module(x.to(torch.bfloat16))
            torch.cuda.synchronize()
            n_module = fused_attention_bdt.launches
            fused_attention_bdt.launches = 0
            fast = server.forward(x)
            torch.cuda.synchronize()
            n_fast = fused_attention_bdt.launches
            with plain_versions():
                pl = module(x.to(torch.bfloat16))
            ref, fast32 = model(x), fast_inference_forward(model, x)
        torch.cuda.synchronize()
        launches += n_module
        for out in (got, fast, pl, fast32):
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                raise AssertionError(f"TDANet: bad output {tuple(out.shape)}")
        scale = float(ref.abs().max())
        rel32 = max_err(fast32, ref) / scale
        print(f"  TDANet B={batch} x 2 s (output scale {scale:.4g}): K4 launches, module path {n_module} "
              f"(want {TDANET_K4}), fast path {n_fast} (want 0); fast path vs f32 module: f32 "
              f"{rel32:.3g} of the scale (bound 1e-4), bf16 max abs {max_err(fast, ref):.6g}, SNR "
              f"{snr_db(ref, fast):.2f} dB (bound 20), plain bf16 module SNR {snr_db(ref, pl):.2f} dB")
        if (n_module, n_fast) != (TDANET_K4, 0):
            raise AssertionError(f"TDANet launched K4 {n_module} (module) and {n_fast} (fast) times")
        if not (rel32 <= 1e-4 and snr_db(ref, fast) > 20.0):
            raise AssertionError(f"TDANet fast path: f32 {rel32} of the scale, bf16 {snr_db(ref, fast)} dB")
        check_rule(f"TDANet module path B={batch} x 2 s", max_err(got, ref), max_err(pl, ref))
    rand = rand_maker(35, dev)
    print("  K4 vs plain at TDANet's shapes, unit-normal bf16 q, k, v")
    k4_err = max(kernel_vs_plain(f"[BH, dh, T] = {[*TDANET_K4_SHAPE, b]}", fused_attention_bdt,
                                 attention_bdt_reference, [rand((*TDANET_K4_SHAPE, b)) for _ in range(3)], 2e-2)
                 for b in (1, 2))
    return k4_err, launches


def afrcnn_checks(dev, model) -> None:
    """Phase 22: AFRCNN at B=1 x 2 s: the bf16 module (``serve``'s
    "kernels") against the f32 module under the 1.5x rule (its plain bf16
    path is the same module: it has no kernel), no kernel launched."""
    print("phase 22: AFRCNN (afrcnn_lrs2, 16 kHz, full width and depth), bf16 module vs f32")
    kernel, plain, f32 = dualpath_paths(model)
    x = torch.from_numpy(np.random.default_rng(36).standard_normal((1, 2 * SR)).astype(np.float32)).to(dev)
    counters = [c for _, c, _ in tasnet_counters()]
    for c in counters:
        c.launches = 0
    got = kernel(x)
    torch.cuda.synchronize()
    launched = [c.launches for c in counters]
    ref, pl = f32(x), plain(x)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"AFRCNN: bad output {tuple(got.shape)}")
    print(f"  AFRCNN B=1 x 2 s (output scale {float(ref.abs().max()):.4g}): launches K4, K5, K6 {launched} "
          f"(want none); bf16 SNR {snr_db(ref, got):.2f} dB")
    if any(launched):
        raise AssertionError(f"AFRCNN launched kernels: {launched}")
    check_rule("AFRCNN B=1 x 2 s", max_err(got, ref), max_err(pl, ref))


def new_models_timing(dev, card, bsrnn, tdanet, afrcnn) -> dict:
    """Phase 24: BSRNN at B=1 and 4 x 4 s (kernel path, plain bf16 path, f32
    module; the kernel path profiled), K5 and K6 alone at BSRNN's B=1 shapes
    beside their plain versions, bf16 ``nn.LSTM`` on the same shape and
    their bounds, K5 also a step; a TDANet call on the fast path and on the
    module path, and an AFRCNN call.  Returns K5's and K6's entries."""
    import copy

    from audio_only_speech_separation_tpu_torch.models.tdanet import fast_inference_forward
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        recurrence_cluster,
        resident_bilstm,
        resident_bilstm_reference,
        resident_cluster,
    )

    print(f"phase 24: timing, BSRNN at B=1 and 4 x 4 s x 8 kHz, TDANet and AFRCNN at B=1 x 2 s x 16 kHz, "
          f"on {card}")
    for batch in (1, 4):
        time_calls(dev, card, {"BSRNN": bsrnn}, batch, 4.0, TSR, 3, tasnet_counters()[1:])
    rand = rand_maker(37, dev)
    (T5, D5, B5, H5), (T6, B6, Din6, H6, D6) = bsrnn_shapes(1)
    xw, whh = lstm_kernel_inputs(rand, k5_shape=bsrnn_shapes(1)[0])
    x6, wih6, whh6, b6 = lstm_kernel_inputs(rand, k6_shape=bsrnn_shapes(1)[1])

    with torch.no_grad():
        k5 = {"ms": back_to_back_ms(lambda: fused_bilstm(xw, whh), 10),
              "plain_ms": back_to_back_ms(lambda: bilstm_reference(xw, whh), 2),
              "library_ms": lstm_library_ms(dev, rand((B5, T5, 128), 0.5), 128, H5),
              "device_ms": launch_ms(lambda: fused_bilstm(xw, whh), "lstm_recurrence_kernel")}
        k6 = {"ms": back_to_back_ms(lambda: resident_bilstm(x6, wih6, whh6, b6)),
              "plain_ms": back_to_back_ms(lambda: resident_bilstm_reference(x6, wih6, whh6, b6), 5),
              "library_ms": lstm_library_ms(dev, x6, Din6, H6),
              "device_ms": launch_ms(lambda: resident_bilstm(x6, wih6, whh6, b6), "lstm_resident_kernel", 20)}
    k5["bound_ms"], k5["bound_by"] = least_time((xw.numel() + xw.numel() // 4 + whh.numel()) * 2,
                                                2 * T5 * D5 * B5 * H5 * 4 * H5)
    k6["bound_ms"], k6["bound_by"] = least_time(
        (x6.numel() + wih6.numel() + whh6.numel() + T6 * D6 * B6 * H6) * 2 + b6.numel() * 4,
        2 * T6 * D6 * B6 * (Din6 + H6) * 4 * H6)
    for label, d, T, cluster in (
            (f"K5 (T, D, B, H) = {bsrnn_shapes(1)[0]}, bf16 nn.LSTM(128, 256) on [{B5}, {T5}, 128] beside it", k5,
             T5, recurrence_cluster(B5, D5, H5)),
            (f"K6 (T, B, Din, H, D) = {bsrnn_shapes(1)[1]}, bf16 nn.LSTM(128, 256) on [{B6}, {T6}, 128] beside it",
             k6, T6, resident_cluster(B6, D6, Din6, H6))):
        traced = "not traced" if d["device_ms"] is None else f"{d['device_ms']:.4f} ms"
        print(f"  {label}: kernel {d['ms']:.4f} ms a launch (CUDA events, back to back), {traced} on the device "
              f"(torch.profiler)" + ("" if d["device_ms"] is None else f", {d['device_ms'] / T * 1e3:.3f} us a step")
              + f", cluster of {cluster}; plain {d['plain_ms']:.4f} ms; nn.LSTM "
              + ("not timed" if d["library_ms"] is None else f"{d['library_ms']:.4f} ms")
              + f"; bound {d['bound_ms']:.5f} ms ({d['bound_by']}); {card}")

    module = copy.deepcopy(tdanet).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(38).standard_normal((1, 2 * SR)).astype(np.float32)).to(dev)
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        runs = {"TDANet fast path (bf16)": lambda: fast_inference_forward(module, xb),
                "TDANet module path (bf16, K4)": lambda: module(xb),
                "TDANet f32 module": lambda: tdanet(x)}
        ms = in_turns(runs, 5)
        for name, v in ms.items():
            print(f"  B=1 x 2 s x 16 kHz, {name}: {v:.4f} ms/call, {2.0 / (v / 1000):.2f} audio-sec/s "
                  f"(median of 5, {card})")
        device_profile("B=1 x 2 s x 16 kHz, TDANet fast path", runs["TDANet fast path (bf16)"],
                       ms["TDANet fast path (bf16)"], (), card)
        device_profile("B=1 x 2 s x 16 kHz, TDANet module path", runs["TDANet module path (bf16, K4)"],
                       ms["TDANet module path (bf16, K4)"], tasnet_counters()[:1], card)
    time_calls(dev, card, {"AFRCNN": afrcnn}, 1, 2.0, SR, 3, ())
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return k5, k6


# The training settings of the served families (configs/*.yml, written out):
# audionet name and config, sample rate, train batch, segment (s), and
# threshold_byloss of the train loss
TRAIN_FAMILIES = {
    "DPRNN": ("TasNet", dict({k: v for k, v in WSJ0_TASNET.items() if k != "sample_rate"}, module="DPRNN"),
              TSR, 2, 4.0, False),
    "DPTNet": ("TasNet", dict({k: v for k, v in WSJ0_TASNET.items() if k != "sample_rate"}, module="DPTNet"),
               TSR, 2, 4.0, False),
    "BSRNN": ("BSRNN", BSRNN_WSJ0, TSR, 4, 4.0, False),
    "Sepformer": ("Sepformer", SEPFORMER, SR, 1, 2.0, True),
    "TDANet": ("TDANet", TDANET_LRS2, SR, 2, 2.0, True),
    "AFRCNN": ("AFRCNN", AFRCNN_LRS2, SR, 6, 2.0, True),
}
# K4, K5, K6 launches of one bf16 forward at the train shape, in a train step
# (dropout on) and in eval: DPRNN's rows (164 chunks of 100 frames) and
# columns (200 sequences of 82 chunks) both past 128 sequences take K6, 6
# layers; DPTNet's MHA has no dropout (12 K4); BSRNN's band RNNs (32
# sequences) K5 and band-comm RNNs (2004) K6, 8 repeats; Sepformer's and
# TDANet's attention has dropout 0.1, so K4 only in eval (32 and 16)
TRAIN_LAUNCHES = {"DPRNN": ((0, 0, 12), (0, 0, 12)), "DPTNet": ((12, 0, 12), (12, 0, 12)),
                  "BSRNN": ((0, 8, 8), (0, 8, 8)), "Sepformer": ((0, 0, 0), (SEPFORMER_K4, 0, 0)),
                  "TDANet": ((0, 0, 0), (TDANET_K4, 0, 0)), "AFRCNN": ((0, 0, 0), (0, 0, 0))}
TRAIN_STEPS = 2  # optimizer steps of a training run (one epoch)
# One bf16 train step each (phase 34) of Sandglasset and DPRNNTasNet, at B=2 x
# 2 s x 8 kHz: Sandglasset's intra BiLSTMs (262 sequences) K6 and its six
# attentions K4 (dropout 0); DPRNNTasNet's rows (256 sequences) K6 and
# columns (64) K5
STEP_FAMILIES = {"Sandglasset": ("Sandglasset", SANDGLASSET, TSR, 2, 2.0, False),
                 "DPRNNTasNet": ("DPRNNTasNet", DPRNN_TASNET, TSR, 2, 2.0, False)}
TRAIN_LAUNCHES.update({"Sandglasset": ((6, 0, 6), (6, 0, 6)), "DPRNNTasNet": ((0, 6, 6), (0, 6, 6))})


def family_settings(family: str):
    """(audionet name, config, sample rate, batch, segment s, threshold_byloss)."""
    return TRAIN_FAMILIES[family] if family in TRAIN_FAMILIES else STEP_FAMILIES[family]


# K7's times before its redesign (three runs of the earlier design on an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 6), us a call, printed
# beside this run's for the reader; nothing is gated on them
K7_BEFORE_US = {(torch.float32, False): "8.72-8.99", (torch.float32, True): "14.33-15.04",
             (torch.bfloat16, False): "6.67-7.19", (torch.bfloat16, True): "15.77-16.01"}


def micro_vpu_bounds() -> dict:
    """K7's bound in each of the script's four cases: {(dtype, stats): (least
    ms, "bytes" or "operations")}, the bytes over HBM bandwidth or the
    script's operation count over the CUDA cores' rate (132 SMs x 128 f32
    lanes x 2 x the max SM clock, twice that for packed bf16x2), whichever
    is larger."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import micro_vpu as k7

    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    f32_rate = 132 * 128 * 2 * clock_mhz * 1e6  # f32 operations a second on the CUDA cores
    bounds = {}
    for dt in (torch.float32, torch.bfloat16):
        for ws in (False, True):
            itemsize = 2 if dt == torch.bfloat16 else 4
            t_bytes = 2 * k7.N * k7.C * itemsize / PEAK_BYTES * 1e3
            t_ops = k7.N * k7.C * k7.ops_per_element(ws) / (f32_rate * (2 if itemsize == 2 else 1)) * 1e3
            bounds[dt, ws] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bounds


def micro_vpu_checks(card: str) -> dict:
    """Phase 25: K7 against its plain version (the script's where-form
    chain) at the script's [2048, 512] in its four cases, at the script's
    slope and at 0.75 (the kernel's min and max selects): f32 within 1e-5
    of the output's magnitude, bf16 exactly, the sum of squares within 1e-5
    (600 * 2**-24 at 0.75); then its main path, the
    script's four timed cases (``ops/kernels/micro_vpu.py::bench``), with
    the launches counted from 0 (one a call, with or without stats); each
    case beside its bound (``micro_vpu_bounds``) and the earlier design's
    time.  Returns
    K7's entry of the kernels line (the bf16 case with stats, K1's
    epilogue case)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import micro_vpu as k7
    from audio_only_speech_separation_tpu_torch.ops.kernels._build import load_library

    print("phase 25: K7 (micro_vpu) vs its plain version at [2048, 512], then its four timed cases")
    cases = [(dt, ws) for dt in (torch.float32, torch.bfloat16) for ws in (False, True)]
    errs, plain_ms = {}, {}
    # the script's slope (min select in f32; 1 in bf16) and one below 1 (max
    # select), whose chain settles on 2, so that every addition of a
    # thread's in-order sum of squares rounds alike: its bound is then the
    # worst case of 512 such additions and the plain version's 64, in f32
    slopes = [(k7.A, k7.B, 1e-5), (0.75, 0.5, 600 * 2.0**-24)]
    for dt, ws in cases:
        x = k7.bench_input(dt)
        for a, b, stats_bound in slopes:
            with torch.no_grad():
                got, total = k7.micro_vpu(x, ws, return_stats=True, a=a, b=b)
                again, total_again = k7.micro_vpu(x, ws, return_stats=True, a=a, b=b)
                want, want_total = k7.micro_vpu_reference(x, ws, return_stats=True, a=a, b=b)
            torch.cuda.synchronize()
            err, scale = max_err(got, want), float(want.float().abs().max())
            limit = 1e-5 * scale if dt == torch.float32 else 0.0
            stats_rel = abs(float(total) - float(want_total)) / float(want_total) if ws else 0.0
            print(f"  {dt} stats={ws} a={a} ({k7.select_for(a)} select): max abs {err:.6g} (bound {limit:.3g}, "
                  f"scale {scale:.4g})" + (f", sum of squares {float(total):.6g} vs {float(want_total):.6g} "
                                           f"(rel {stats_rel:.3g}, bound {stats_bound:.3g})" if ws else ""))
            same = torch.equal(got, again) and (not ws or float(total) == float(total_again))
            if not same or not err <= limit or not stats_rel <= stats_bound:
                raise AssertionError(f"K7 {dt} stats={ws} a={a}: differs from its plain version or from run to run")
            if a == k7.A:
                errs[dt, ws] = err
        plain_ms[dt, ws] = cuda_time(lambda: k7.micro_vpu_reference(x, ws), reps=5)
    k7.micro_vpu.launches = 0
    rates = {case: k7.bench(*case) for case in cases}
    torch.cuda.synchronize()
    launches = k7.micro_vpu.launches
    lib = load_library()
    want = sum(201 * lib.micro_vpu_launches(int(ws)) for _, ws in cases)  # 200 timed calls and a warm-up each
    print(f"  launches {launches} (want {want}: one a call)")
    if launches != want:
        raise AssertionError(f"K7: {launches} launches, want {want}")
    bounds = micro_vpu_bounds()
    for dt, ws in cases:
        r = rates[dt, ws]
        print(f"  {dt} stats={ws}: {r['us']:.4f} us a call (before the redesign: {K7_BEFORE_US[dt, ws]} us), {r['gops']:.1f} Gop/s "
              f"(the script's count), plain {plain_ms[dt, ws]:.4f} ms, bound {bounds[dt, ws][0] * 1e3:.4f} us "
              f"({bounds[dt, ws][1]}), {bounds[dt, ws][0] * 1e3 / r['us']:.3f} of it; {card}")
    f32_r, bf_r = rates[torch.float32, False]["gops"], rates[torch.bfloat16, False]["gops"]
    print(f"  bf16x2 / f32 rate: {bf_r / f32_r:.3f} without stats, "
          f"{rates[torch.bfloat16, True]['gops'] / rates[torch.float32, True]['gops']:.3f} with stats")
    case = (torch.bfloat16, True)
    return {"name": "micro_vpu", "route": "cuda", "source": CSRC + "micro_vpu.cu",
            "replaces": "scripts/micro_vpu.py:22", "launches": launches, "max_abs_err": max(errs.values()),
            "ms": rates[case]["us"] / 1e3, "plain_ms": plain_ms[case], "bound_ms": bounds[case][0],
            "bound_by": bounds[case][1], "library_ms": None}


def train_model(family: str, seed: int, dev):
    """``family`` at its config's full width and depth, seeded weights."""
    from audio_only_speech_separation_tpu_torch import models

    name, cfg, sr = family_settings(family)[:3]
    if name == "TasNet":
        return tasnet_model(cfg["module"], seed, dev)
    return seeded_model(models.get(name), cfg, sr, seed, dev)


def train_batch(family: str, seed: int, dev):
    """A seeded (mix, sources) batch at the config's batch and segment."""
    sr, batch, secs = family_settings(family)[2:5]
    rng = np.random.default_rng(seed)
    srcs = (0.3 * rng.standard_normal((batch, 2, int(secs * sr)))).astype(np.float32)
    return torch.from_numpy(srcs.sum(1)).to(dev), torch.from_numpy(srcs).to(dev)


def train_paths(model, exp_dir: str, dev):
    """{"kernel path", "plain bf16 path", "f32 module"}: ``Trainer``'s bf16
    forward (the module on bf16 casts of its f32 parameters), the same
    inside ``plain_versions()`` (forward and backward), and its f32
    forward, each as (a context to run the step in, the forward)."""
    import contextlib

    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer

    def forward(precision):
        return Trainer(exp_dir, precision=precision, device=dev,
                       logger=CSVLogger(os.path.join(exp_dir, "logs")))._make_forward(model)

    bf16 = forward("bfloat16")
    return {"kernel path": (contextlib.nullcontext, bf16), "plain bf16 path": (plain_versions, bf16),
            "f32 module": (contextlib.nullcontext, forward("float32"))}


def train_step_checks(dev, root: str, families) -> None:
    """Phases 26 and 34: one bf16 train step of each of ``families`` (DPRNN,
    DPTNet and BSRNN at their configs' full width, batch and segment;
    Sandglasset and DPRNNTasNet at full width, STEP_FAMILIES' batch), three
    ways: through the kernels, inside ``plain_versions()``, and the f32
    module.  All gradients as one vector under the rule of PERF.md section
    2, |g_kernel - g_f32| <= 1.5 |g_plain - g_f32| + 1e-3 |g_f32|; the
    forward launches exactly TRAIN_LAUNCHES' K4, K5 and K6, the backward
    none."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr

    counters = tasnet_counters()
    for family in families:
        model = train_model(family, 51, dev).train()
        mix, srcs = train_batch(family, 52, dev)
        loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=family_settings(family)[5])
        params = list(model.parameters())
        grads, losses_, counts = {}, {}, {}
        for path, (context, forward) in train_paths(model, os.path.join(root, family), dev).items():
            for _, c, _ in counters:
                c.launches = 0
            with context():
                loss = loss_fn(forward(mix), srcs)
                torch.cuda.synchronize()
                fwd = tuple(c.launches for _, c, _ in counters)
                grads[path] = torch.cat([g.flatten().float() for g in torch.autograd.grad(loss, params)])
                torch.cuda.synchronize()
            counts[path] = (fwd, tuple(c.launches for _, c, _ in counters))
            losses_[path] = float(loss.detach())
        want = TRAIN_LAUNCHES[family][0]
        e_k = float((grads["kernel path"] - grads["f32 module"]).norm())
        e_p = float((grads["plain bf16 path"] - grads["f32 module"]).norm())
        n_f = float(grads["f32 module"].norm())
        bound = 1.5 * e_p + 1e-3 * n_f
        print(f"  {family} (B={mix.shape[0]} x {mix.shape[1] / family_settings(family)[2]:g} s): loss "
              + ", ".join(f"{k} {v:.6g}" for k, v in losses_.items())
              + f"; gradients |kernel - f32| {e_k:.6g}, |plain - f32| {e_p:.6g}, |f32| {n_f:.6g}, bound {bound:.6g}"
              f"; K4, K5, K6 launches in the forward {counts['kernel path'][0]} (want {want}), after the "
              f"backward {counts['kernel path'][1]}; plain path {counts['plain bf16 path'][1]}")
        if counts["kernel path"] != (want, want) or any(counts["plain bf16 path"][1]) or any(
                counts["f32 module"][1]):
            raise AssertionError(f"{family}: launches {counts}, want {want} in the forward and none after")
        if not (torch.isfinite(grads["kernel path"]).all() and e_k <= bound):
            raise AssertionError(f"{family}: train-step gradients {e_k} > 1.5 * {e_p} + 1e-3 * {n_f}")
        del model, grads


def train_config(family: str, data_root: str, exp_name: str) -> dict:
    """The config of ``family`` (configs/*.yml, written out) with the data
    under data_root, one epoch and bf16 training."""
    name, audionet, sr, batch, secs, by_loss = TRAIN_FAMILIES[family]

    def pit(sdr_type, threshold_byloss):
        return {"loss_func": "PITLossWrapper", "sdr_type": sdr_type,
                "config": {"pit_from": "pw_mtx", "threshold_byloss": threshold_byloss}}

    return {
        "audionet": {"audionet_name": name, "audionet_config": dict(audionet)},
        "loss": {"train": pit("pairwise_neg_snr", by_loss), "val": pit("pairwise_neg_sisdr", False)},
        "training": {"epochs": 1, "precision": "bfloat16",
                     "early_stop": {"monitor": "val_loss/dataloader_idx_0", "mode": "min", "patience": 30}},
        "optimizer": {"optim_name": "adam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"sche_name": "ReduceLROnPlateau", "sche_config": {"patience": 15, "factor": 0.5}},
        "datamodule": {"data_name": "LRS2DataModule", "data_config": {
            "train_dir": os.path.join(data_root, "tr"), "valid_dir": os.path.join(data_root, "cv"),
            "test_dir": os.path.join(data_root, "tt"), "n_src": 2, "sample_rate": sr, "fps": 25,
            "segment": secs, "normalize_audio": False, "batch_size": batch, "num_workers": 8,
            "pin_memory": True, "persistent_workers": False, "audio_only": True}},
        "exp": {"exp_name": exp_name},
    }


def train_cli_checks(dev, root: str) -> dict:
    """Phase 27: ``audio_train.main`` with ``precision: bfloat16`` for each
    family at its config's full width, batch and segment, on synthetic
    manifests: one epoch of TRAIN_STEPS steps, one validation and one test
    batch.  Finite train, val and test losses; the K4-K6 launches exactly
    TRAIN_LAUNCHES' a forward (a train step's and an eval batch's); the
    best_model.pth it wrote loads with ``from_pretrain`` and serves five
    requests on the card.  Returns {K4, K5, K6: launches in all runs}."""
    from audio_only_speech_separation_tpu_torch import audio_train
    from audio_only_speech_separation_tpu_torch.models import from_pretrain
    from audio_only_speech_separation_tpu_torch.serve import Server, serve

    print(f"phase 27: audio_train.main, bf16, every family at full width ({TRAIN_STEPS} steps, 1 epoch)")
    counters = tasnet_counters()
    total = {g: 0 for g, _, _ in counters}
    cwd = os.getcwd()
    for i, family in enumerate(TRAIN_FAMILIES):
        sr, batch, secs = TRAIN_FAMILIES[family][2:5]
        work = tempfile.mkdtemp(prefix=f"train_{family}_", dir=root)
        n = int(secs * sr)
        write_manifests(os.path.join(work, "data"), {"tr": [n] * (TRAIN_STEPS * batch), "cv": [n] * batch,
                                                     "tt": [n] * batch}, 60 + i, mix="mix", n_src=2, sr=sr)
        for _, c, _ in counters:
            c.launches = 0
        os.chdir(work)
        try:
            t0 = time.perf_counter()
            exp_dir = audio_train.main(train_config(family, os.path.join(work, "data"), family))
            torch.cuda.synchronize()
            secs_run = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launched = tuple(c.launches for _, c, _ in counters)
        train_fwd, eval_fwd = TRAIN_LAUNCHES[family]
        want = tuple(TRAIN_STEPS * t + 2 * e for t, e in zip(train_fwd, eval_fwd))
        with open(os.path.join(work, "Experiments", "tensorboard_logs", family, "scalars.csv")) as f:
            scalars = {row.split(",")[1]: float(row.split(",")[2]) for row in f.read().splitlines()[1:]}
        model = from_pretrain(os.path.join(exp_dir, "best_model.pth"), device=dev)
        rng = np.random.default_rng(70 + i)
        wavs = [rng.standard_normal(int(s * sr)).astype(np.float32) for s in EVAL_SECONDS]
        est = serve(model, wavs, use_bf16=True, device=dev)
        torch.cuda.synchronize()
        print(f"  {family}: {secs_run:.1f} s; train_loss {scalars.get('train_loss')}, val_loss "
              f"{scalars.get('val_loss')}, test_loss {scalars.get('test_loss')}; K4, K5, K6 launches {launched} "
              f"(want {want}); best_model.pth served five requests ({Server(model, True, dev).dispatch})")
        for g, n_launched in zip(total, launched):
            total[g] += n_launched
        if launched != want:
            raise AssertionError(f"{family}: the training run launched {launched}, want {want}")
        if not all(np.isfinite(scalars.get(k, float("nan"))) for k in ("train_loss", "val_loss", "test_loss")):
            raise AssertionError(f"{family}: non-finite losses {scalars}")
        if any(e.shape != (2, len(w)) or not np.isfinite(e).all() for e, w in zip(est, wavs)):
            raise AssertionError(f"{family}: best_model.pth served bad estimates")
        shutil.rmtree(work, ignore_errors=True)
        del model
    return total


def plain_backward_seconds(step) -> dict:
    """Host seconds that one call of ``step`` spends in the K5 and K6
    wrappers' backwards (autograd through their plain versions,
    ``ops/kernels/__init__.py::grad_through_plain``), each call bracketed
    by synchronizations: {plain version's name: seconds}."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import lstm as klstm

    spent, inner = {}, klstm.grad_through_plain

    def timed(plain, saved, needs, g):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(plain, saved, needs, g)
        torch.cuda.synchronize()
        spent[plain.__name__] = spent.get(plain.__name__, 0.0) + time.perf_counter() - t0
        return out

    klstm.grad_through_plain = timed
    try:
        step()
        torch.cuda.synchronize()
    finally:
        klstm.grad_through_plain = inner
    return spent


def train_timing(dev, card: str, root: str) -> None:
    """Phase 28: a train step of each family at its config's batch and
    segment (forward, PIT loss, backward, clipping and Adam, as
    ``Trainer.fit`` takes it) on the kernel path, the plain bf16 path and
    the f32 module, timed in turns (CUDA events, median of 3 after a
    warm-up; the phase is host-paced and the script's longest), the
    kernel path's steps split into forward, backward and the
    optimizer; one kernel-path step under torch.profiler (device work by
    kernel, idle share); and for the LSTM families the host time of one
    kernel-path step spent in the backwards of K5 and K6, which recompute
    through their plain versions."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.train import make_optimizer

    print(f"phase 28: train-step timing, every family at its config's batch and segment, on {card}")
    t_phase = time.perf_counter()
    for family in TRAIN_FAMILIES:
        model = train_model(family, 81, dev).train()
        mix, srcs = train_batch(family, 82, dev)
        loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=TRAIN_FAMILIES[family][5])
        opt = make_optimizer(model.parameters(), optim_name="adam", lr=1e-3, grad_clip=5.0)
        parts = {"forward": [], "backward": [], "optimizer": []}

        def step(context, forward, split=False):
            def run():
                events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                with context():
                    opt.zero_grad()
                    events[0].record()
                    loss = loss_fn(forward(mix), srcs)
                    events[1].record()
                    loss.backward()
                    events[2].record()
                    opt.step()
                    events[3].record()
                if split:
                    events[3].synchronize()
                    for j, k in enumerate(parts):
                        parts[k].append(events[j].elapsed_time(events[j + 1]))
            return run

        runs = {path: step(*cf, split=path == "kernel path")
                for path, cf in train_paths(model, os.path.join(root, f"t_{family}"), dev).items()}
        reps = 3
        for fn in runs.values():  # one warm-up each
            fn()
        torch.cuda.synchronize()
        for v in parts.values():
            v.clear()
        times = {k: [] for k in runs}
        for _ in range(reps):
            for name, fn in runs.items():
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
        ms = {k: statistics.median(v) for k, v in times.items()}
        split = {k: statistics.median(v) for k, v in parts.items()}
        shape = f"B={mix.shape[0]} x {TRAIN_FAMILIES[family][4]:g} s x {TRAIN_FAMILIES[family][2] // 1000} kHz"
        print(f"  {family} {shape}: train step " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f" (median of {reps}); kernel path forward {split['forward']:.4f}, backward "
              f"{split['backward']:.4f}, optimizer {split['optimizer']:.4f} ms (medians); {card}")
        if family in ("DPRNN", "DPTNet", "BSRNN"):
            spent = plain_backward_seconds(runs["kernel path"])
            print(f"  {family} {shape}: one kernel-path step spends " + ", ".join(
                f"{1e3 * t:.1f} ms in {'K5' if k == 'bilstm_reference' else 'K6'}'s backward"
                for k, t in sorted(spent.items())) + " (through the plain versions, host clock, synchronized)")
        device_profile(f"{family} {shape}, kernel-path train step", runs["kernel path"], ms["kernel path"],
                       tasnet_counters(), card, calls=1, cpu=False)
        print(f"  {time.perf_counter() - t_phase:.1f} s into phase 28")
        del model, opt, runs
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")



@contextlib.contextmanager
def noting_calls(targets):
    """Each (module, name, note) of ``targets``: inside the block,
    module.name calls note(*args) and then what it was."""
    originals = [getattr(mod, name) for mod, name, _ in targets]

    def noted(fn, note):
        def run(*args):
            note(*args)
            return fn(*args)
        return run

    for (mod, name, note), fn in zip(targets, originals):
        setattr(mod, name, noted(fn, note))
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(targets, originals):
            setattr(mod, name, fn)


def dispatch_modules():
    from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
    from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn

    return port_attention, port_rnn


@contextlib.contextmanager
def counting_plain_versions():
    """{"K4", "K5", "K6": calls} of the kernels' plain versions made through
    the models' dispatch (``ops/attention.py``, ``ops/rnn.py``) inside the
    block: a kernel path inside the envelopes makes none."""
    port_attention, port_rnn = dispatch_modules()
    calls = {"K4": 0, "K5": 0, "K6": 0}

    def count(label):
        return lambda *args: calls.__setitem__(label, calls[label] + 1)

    with noting_calls([(port_attention, "attention_bdt_reference", count("K4")),
                       (port_rnn, "bilstm_reference", count("K5")),
                       (port_rnn, "resident_bilstm_reference", count("K6"))]):
        yield calls


@contextlib.contextmanager
def recording_kernel_shapes():
    """{"K4": {[BH, dh, T]}, "K5": {(T, D, B, H)}, "K6": {(T, B, Din, H,
    D)}}: the shapes the models' dispatch hands each kernel's wrapper inside
    the block."""
    port_attention, port_rnn = dispatch_modules()
    shapes = {"K4": set(), "K5": set(), "K6": set()}

    def k5(xw, w_hh):
        T, D, B, gates = xw.shape
        shapes["K5"].add((T, D, B, gates // 4))

    def k6(x, w_ih, w_hh, bias):
        B, T, Din = x.shape
        shapes["K6"].add((T, B, Din, w_hh.shape[1], w_hh.shape[0]))

    with noting_calls([(port_attention, "fused_attention_bdt", lambda q, k, v: shapes["K4"].add(tuple(q.shape))),
                       (port_rnn, "fused_bilstm", k5), (port_rnn, "resident_bilstm", k6)]):
        yield shapes


def served_model_checks(dev, label: str, model, cases, sr: int = TSR, secs: float = 2.0):
    """``model`` served as "kernels" (``dualpath_paths``) at each (batch,
    (K4, K5, K6) launches a call) of ``cases``, B x secs s: the launches
    exact, no plain version of a kernel called on the kernel path, finite
    output of the f32 module's shape, within the 1.5x rule of the f32
    module against the plain bf16 path.  Returns the kernel path's launches
    summed over the cases and the shapes it gave each kernel
    (``recording_kernel_shapes``)."""
    kernel, plain, f32 = dualpath_paths(model)
    counters = [c for _, c, _ in tasnet_counters()]
    total = [0, 0, 0]
    shapes = {"K4": set(), "K5": set(), "K6": set()}
    for batch, want in cases:
        x = torch.from_numpy(np.random.default_rng(90 + batch).standard_normal(
            (batch, int(secs * sr))).astype(np.float32)).to(dev)
        for c in counters:
            c.launches = 0
        with counting_plain_versions() as plain_calls, recording_kernel_shapes() as seen:
            got = kernel(x)
            torch.cuda.synchronize()
        launched = tuple(c.launches for c in counters)
        ref, pl = f32(x), plain(x)
        torch.cuda.synchronize()
        for out in (got, pl):
            if out.shape != ref.shape or not torch.isfinite(out.float()).all():
                raise AssertionError(f"{label}: bad output {tuple(out.shape)}")
        print(f"  {label} B={batch} x {secs:g} s (output scale {float(ref.abs().max()):.4g}): launches K4, K5, K6 "
              f"{launched} (want {want}); plain versions called on the kernel path {tuple(plain_calls.values())}; "
              f"shapes {({g: sorted(v) for g, v in seen.items() if v})}")
        if launched != tuple(want) or any(plain_calls.values()):
            raise AssertionError(f"{label} B={batch}: launches {launched}, plain versions {plain_calls}")
        check_rule(f"{label} B={batch} x {secs:g} s", max_err(got, ref), max_err(pl, ref))
        total = [t + n for t, n in zip(total, launched)]
        for g in shapes:
            shapes[g] |= seen[g]
    return total, shapes


def kernels_at_shapes(dev, label: str, shapes, written=None) -> tuple:
    """K4, K5 and K6 against their plain versions at every shape of
    ``shapes`` (``served_model_checks``'s record of a model's calls) on
    seeded inputs as in phases 10-13: unit-normal q, k, v; the validator's
    LSTM inputs.  ``written``, where given, holds the shapes this script
    states for the model (the timing phase's): they must be the recorded
    ones.  Returns the worst max abs errors (0.0 for a kernel not called)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        resident_bilstm,
        resident_bilstm_reference,
    )

    for g, want in (written or {}).items():
        if set(want) != shapes[g]:
            raise AssertionError(f"{label}: {g} shapes called {sorted(shapes[g])}, stated {sorted(want)}")
    rand = rand_maker(91, dev)
    print(f"  K4, K5, K6 vs plain at every shape {label}'s calls gave them")
    k4 = [kernel_vs_plain(f"K4 [BH, dh, T] = {list(s)}", fused_attention_bdt, attention_bdt_reference,
                          [rand(s) for _ in range(3)], 2e-2) for s in sorted(shapes["K4"])]
    k5 = [kernel_vs_plain(f"K5 (T, D, B, H) = {s}", fused_bilstm, bilstm_reference,
                          lstm_kernel_inputs(rand, k5_shape=s), 1e-2) for s in sorted(shapes["K5"])]
    k6 = [kernel_vs_plain(f"K6 (T, B, Din, H, D) = {s}", resident_bilstm, resident_bilstm_reference,
                          lstm_kernel_inputs(rand, k6_shape=s), 1e-2) for s in sorted(shapes["K6"])]
    return tuple(max(errs, default=0.0) for errs in (k4, k5, k6))


def zoo_checks(dev):
    """Phases 29-31: Sandglasset, DPRNNTasNet and the other TasNet modules
    served at full width under ``served_model_checks``, and K4, K5 and K6
    against their plain versions at every shape those calls gave them.
    Returns (the models, the kernel paths' launches, the worst K4, K5, K6
    max abs errors)."""
    from audio_only_speech_separation_tpu_torch.models import DPRNNTasNet, Sandglasset, TasNet

    errs = []
    print("phase 29: Sandglasset (defaults, 8 kHz, full width and depth), kernel path vs plain bf16 vs f32")
    sandglasset = seeded_model(Sandglasset, SANDGLASSET, TSR, 92, dev)
    launched, shapes = served_model_checks(dev, "Sandglasset", sandglasset, [(8, SANDGLASSET_LAUNCHES),
                                                                              (1, SANDGLASSET_LAUNCHES)])
    stated = [sandglasset_shapes(b) for b in (8, 1)]
    errs.append(kernels_at_shapes(dev, "Sandglasset", shapes, {
        "K4": [s for k4, _ in stated for s in k4.values()], "K5": [], "K6": [k6 for _, k6 in stated]}))

    print("phase 30: DPRNNTasNet (defaults, 8 kHz, full width and depth), kernel path vs plain bf16 vs f32")
    dprnn_tasnet = seeded_model(DPRNNTasNet, DPRNN_TASNET, TSR, 93, dev)
    more, shapes = served_model_checks(dev, "DPRNNTasNet", dprnn_tasnet,
                                       sorted(DPRNN_TASNET_LAUNCHES.items(), reverse=True))
    launched = [a + b for a, b in zip(launched, more)]
    errs.append(kernels_at_shapes(dev, "DPRNNTasNet", shapes,
                                  {"K4": [], "K5": DPRNN_TASNET_K5, "K6": DPRNN_TASNET_K6}))

    print("phase 31: TasNet's other separator modules (wsj0 widths, group size 2 where they communicate), "
          "B=8 x 2 s")
    wsj0 = {k: v for k, v in WSJ0_TASNET.items() if k not in ("sample_rate", "group_size")}
    modules = {}
    for label, (G, want) in TASNET_MODULES.items():
        modules[label] = seeded_model(TasNet, dict(wsj0, module=label.split()[0], group_size=G), TSR, 94, dev)
        more, shapes = served_model_checks(dev, f"TasNet {label}", modules[label], [(8, want)])
        launched = [a + b for a, b in zip(launched, more)]
        errs.append(kernels_at_shapes(dev, f"TasNet {label}", shapes))
    worst = tuple(max(e[i] for e in errs) for i in range(3))
    return {"Sandglasset": sandglasset, "DPRNNTasNet": dprnn_tasnet, **modules}, launched, worst


def zoo_eval_cli(dev, zoo) -> list:
    """Phase 32: the eval CLI as in phase 18 on Sandglasset (K4, K6),
    DPRNNTasNet (K5, K6 at batch 1) and the DPTNet TasNet with group size 2
    (K4, K5, K6).  Returns their K4, K5, K6 launches."""
    wsj0 = {k: v for k, v in WSJ0_TASNET.items() if k != "sample_rate"}
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    launched = eval_cli_checks(dev, scratch.name, "phase 32: the eval CLI on the card for the new models", {
        "(g) Sandglasset": (None, zoo["Sandglasset"], {"audionet_name": "Sandglasset",
                                                       "audionet_config": dict(SANDGLASSET)},
                            "LRS2DataModule", 2, TSR, ("K4", "K6"), ("K5",), "kernels"),
        "(h) DPRNNTasNet": (None, zoo["DPRNNTasNet"], {"audionet_name": "DPRNNTasNet",
                                                       "audionet_config": dict(DPRNN_TASNET)},
                            "LRS2DataModule", 2, TSR, ("K5",), ("K4",), "kernels"),
        "(i) DPTNet TasNet G2": (None, zoo["DPTNet G2"], {"audionet_name": "TasNet", "audionet_config": dict(
            wsj0, module="DPTNet", group_size=2)}, "LRS2DataModule", 2, TSR, ("K4", "K5", "K6"), (), "kernels"),
    })
    scratch.cleanup()
    return [sum(v[g] for v in launched.values()) for g in ("K4", "K5", "K6")]


def zoo_timing(dev, card, zoo) -> None:
    """Phase 33: Sandglasset and DPRNNTasNet at B=8 and B=1 x 2 s x 8 kHz
    (kernel path, plain bf16 path, f32 module; the kernel path profiled);
    then K4 alone at Sandglasset's three shapes beside its plain version,
    SDPA and its bound, K6 at Sandglasset's intra shape and at
    DPRNNTasNet's B=8 rows and columns, and K5 at its B=1 rows and
    columns, each beside its plain version, bf16 ``nn.LSTM`` and its
    bound."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        fused_attention_bdt,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        fused_bilstm,
        resident_bilstm,
        resident_bilstm_reference,
    )

    print(f"phase 33: timing, Sandglasset and DPRNNTasNet at B=8 and B=1 x 2 s x 8 kHz, on {card}")
    models = {"Sandglasset": zoo["Sandglasset"], "DPRNNTasNet": zoo["DPRNNTasNet"]}
    for batch in (8, 1):
        time_calls(dev, card, models, batch, 2.0, TSR, 5, tasnet_counters())
    rand = rand_maker(95, dev)
    with torch.no_grad():
        for side, (BH, dh, T) in sandglasset_shapes(8)[0].items():
            q, k, v = (rand((BH, dh, T)) for _ in range(3))
            qt, kt, vt = (a.transpose(1, 2).reshape(BH // 8, 8, T, dh).contiguous() for a in (q, k, v))
            d = {"ms": back_to_back_ms(lambda: fused_attention_bdt(q, k, v)),
                 "device_ms": launch_ms(lambda: fused_attention_bdt(q, k, v), "attention_kernel", 20),
                 "plain_ms": back_to_back_ms(lambda: attention_bdt_reference(q, k, v), 5),
                 "library_ms": back_to_back_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt))}
            bound, by = least_time(4 * q.numel() * 2, 4 * BH * T * T * dh)
            traced = "not traced" if d["device_ms"] is None else f"{d['device_ms']:.4f} ms"
            print(f"  K4 Sandglasset {side} [{BH}, {dh}, {T}]: kernel {d['ms']:.4f} ms a launch (CUDA events, back "
                  f"to back), {traced} on the device (torch.profiler); plain {d['plain_ms']:.4f} ms; SDPA on "
                  f"[{BH // 8}, 8, {T}, {dh}] {d['library_ms']:.4f} ms; bound {bound:.5f} ms ({by}); {card}")
        lstm_cases = [("K6 Sandglasset intra", sandglasset_shapes(8)[1]),
                      ("K6 DPRNNTasNet rows B=8", DPRNN_TASNET_K6[0]), ("K6 DPRNNTasNet columns B=8", DPRNN_TASNET_K6[1]),
                      ("K5 DPRNNTasNet rows B=1", DPRNN_TASNET_K5[0]), ("K5 DPRNNTasNet columns B=1", DPRNN_TASNET_K5[1])]
        for label, shape in lstm_cases:
            if label.startswith("K6"):
                T, B, Din, H, D = shape
                args = lstm_kernel_inputs(rand, k6_shape=shape)
                kernel, plain, name = resident_bilstm, resident_bilstm_reference, "lstm_resident_kernel"
                nbytes = (args[0].numel() + args[1].numel() + args[2].numel() + T * D * B * H) * 2 + args[3].numel() * 4
                flops = 2 * T * D * B * (Din + H) * 4 * H
            else:
                T, D, B, H = shape
                Din = DPRNN_TASNET["feature_dim"]  # the rows' and columns' input width
                args = lstm_kernel_inputs(rand, k5_shape=shape)
                kernel, plain, name = fused_bilstm, bilstm_reference, "lstm_recurrence_kernel"
                nbytes = (args[0].numel() + args[0].numel() // 4 + args[1].numel()) * 2
                flops = 2 * T * D * B * H * 4 * H
            d = {"ms": back_to_back_ms(lambda: kernel(*args), 10),
                 "device_ms": launch_ms(lambda: kernel(*args), name, 5),
                 "plain_ms": back_to_back_ms(lambda: plain(*args), 1)}
            lib = lstm_library_ms(dev, rand((B, T, Din), 0.5), Din, H)
            bound, by = least_time(nbytes, flops)
            traced = "not traced" if d["device_ms"] is None else f"{d['device_ms']:.4f} ms"
            print(f"  {label} {shape}: kernel {d['ms']:.4f} ms a launch (CUDA events, back to back), {traced} on "
                  f"the device (torch.profiler); plain {d['plain_ms']:.4f} ms; bf16 nn.LSTM({Din}, {H}) on "
                  f"[{B}, {T}, {Din}] " + ("not timed" if lib is None else f"{lib:.4f} ms")
                  + f"; bound {bound:.5f} ms ({by}); {card}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# The optimizers written after optax's rules (phase 37) and the study's
# parameter shapes: a zero tensor, a 1-element one, and two that adafactor
# factors
OPTAX_RULES = ("rmsprop", "adagrad", "lamb", "novograd", "yogi", "lars", "sm3", "adafactor", "adabelief")
OPT_SHAPES = [(4, 3), (7,), (2, 2, 2), (160, 128), (3, 128, 144), (1,)]


def quality_study(card: str) -> None:
    """Phase 35: the training-quality study (``validate.py``, the JAX
    script's ``kernel_train_quality``) at full width on the card, run as
    its command line (``python -m audio_only_speech_separation_tpu_torch.validate``)
    in a process of its own, which the earlier phases' state does not slow:
    300 Adam steps a run, f32 from seed 0 and bf16 plain and bf16 through
    K2 + K3 from each of six seeds; each run's SI-SDRi after the last step
    (the script's reading) and averaged over the last 50 steps' models,
    final loss and seconds; both gates (|bf16 plain - bf16 kernel| < 0.3 dB
    on the mean over the seeds of the tail averages' difference, printed
    with its standard error; the f32 arm's model served through K1 within
    0.1 dB of its f32 forward) and the script's reading at seed 0, which no
    gate reads."""
    from audio_only_speech_separation_tpu_torch import validate

    print(f"phase 35: the training-quality study (validate.py), full-width ConvTasNet, 300 steps a run, seeds "
          f"{list(validate.SEEDS)}")
    torch.cuda.empty_cache()  # leave the study's process the card's memory
    proc = subprocess.run([sys.executable, "-m", "audio_only_speech_separation_tpu_torch.validate"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                          timeout=900)
    if proc.returncode not in (0, 1) or "{" not in proc.stdout:
        raise RuntimeError(f"validate.py exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    r = json.loads(proc.stdout[proc.stdout.index("{"):])
    if (proc.returncode == 0) != r["ok"]:
        raise AssertionError(f"validate.py exited {proc.returncode} with ok {r['ok']}")
    for row in r["per_seed"]:
        for arm in validate.ARMS:
            if arm in row:
                print(f"  seed {row['seed']} {arm}: SI-SDRi {row[arm]:.4f} dB after the last step, "
                      f"{row[f'{arm}_tail']:.4f} dB over the last {r['tail_steps']} steps' models; final loss "
                      f"{row[f'{arm}_final_loss_db']:.4f} dB, {row[f'{arm}_seconds']:.2f} s; {card}")
        print(f"  seed {row['seed']}: bf16 plain - bf16 kernel {row['tail_delta_db']:.4f} dB over the tail")
    print(f"  over the seeds: f32 {r['f32_tail']:.4f} (seed 0), bf16 plain {r['bf16_plain_tail']:.4f}, bf16 kernel "
          f"{r['bf16_kernel_tail']:.4f} dB (tail averages); bf16 plain - bf16 kernel {r['train_gate_delta_db']:.4f} "
          f"dB, standard error {r['train_gate_se_db']:.4f} dB (gate < {validate.TRAIN_GATE_DB}: "
          f"{r['train_gate_ok']}); the script's reading at seed 0: {r['script_reading_delta_db']:.4f} dB (no gate)")
    print(f"  the f32 arm's model: f32 forward {r['serve_f32_db']:.4f} dB, bf16 through K1 "
          f"{r['serve_bf16_fused_db']:.4f} dB, difference {r['serve_delta_db']:.4f} dB (gate < "
          f"{validate.SERVE_GATE_DB}: {r['serve_gate_ok']})")
    if not r["ok"]:
        raise AssertionError(f"the quality study failed a gate: train {r['train_gate_ok']}, "
                             f"serve {r['serve_gate_ok']}")


def registry_training(dev, card: str, root: str, make_model) -> tuple:
    """Phase 36: the main path's training with the new registry:
    ``audio_train.main`` on the LRS3 config (B=12 x 2 s x 16 kHz) with
    ``fused_forward``, ``remat``, lamb and CosineAnnealingLR, three steps
    and validation, K2 launched twice a step (forward and recomputation)
    and K3 once; then one step's gradients with remat against one without
    on the same model and batch (bit for bit: K2 and K3 are
    deterministic), and the step's time and peak device memory either way.
    Returns (K2, K3) launches of the training run."""
    from audio_only_speech_separation_tpu_torch import audio_train
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import (
        fused_tcn_backward,
        tcn_backward_launches,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
        fused_tcn_separator,
        tcn_separator_launches,
    )
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer, make_optimizer

    print(f"phase 36: audio_train.main, LRS3 (B={TRAIN_B} x 2 s), fused_forward + remat + lamb + CosineAnnealingLR")
    work = tempfile.mkdtemp(prefix="registry_", dir=root)
    data = os.path.join(work, "data")
    write_manifests(data, {"tr": [2 * SR] * 3 * TRAIN_B, "cv": [2 * SR] * TRAIN_B, "tt": [2 * SR] * TRAIN_B}, 80)
    config = lrs3_train_config(data, epochs=1)
    config["training"]["remat"] = True
    config["optimizer"]["optim_name"] = "lamb"
    config["scheduler"] = {"sche_name": "CosineAnnealingLR", "sche_config": {"T_max": 10}}
    config["exp"]["exp_name"] = "registry"
    fused_tcn_separator.launches = fused_tcn_backward.launches = 0
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        audio_train.main(config)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    k2, k3 = fused_tcn_separator.launches, fused_tcn_backward.launches
    steps = 3
    want_k2 = (2 * steps + 2) * tcn_separator_launches(24)  # forward and recompute a step; cv and tt
    want_k3 = steps * tcn_backward_launches(24)
    with open(os.path.join(work, "Experiments", "tensorboard_logs", "registry", "scalars.csv")) as f:
        scalars = {row.split(",")[1]: float(row.split(",")[2]) for row in f.read().splitlines()[1:]}
    want_lr = 0.5 * 1e-3 * (1 + np.cos(np.pi / 10))
    print(f"  {run_s:.1f} s; train_loss {scalars['train_loss']:.6g}, val_loss {scalars['val_loss']:.6g}, "
          f"learning_rate {scalars['learning_rate']:.6g} (want {want_lr:.6g}); K2 launches {k2} (want {want_k2}), "
          f"K3 launches {k3} (want {want_k3})")
    if (k2, k3) != (want_k2, want_k3):
        raise AssertionError("the remat training run did not go through K2 and K3 as counted")
    if not all(np.isfinite(scalars[k]) for k in ("train_loss", "val_loss", "test_loss")):
        raise AssertionError(f"non-finite losses: {scalars}")
    if abs(scalars["learning_rate"] - want_lr) > 1e-9:
        raise AssertionError(f"CosineAnnealingLR gave {scalars['learning_rate']}, want {want_lr}")
    shutil.rmtree(work, ignore_errors=True)

    model = make_model().train()
    rng = np.random.default_rng(81)
    mix = torch.from_numpy(rng.standard_normal((TRAIN_B, 2 * SR)).astype(np.float32)).to(dev)
    srcs = torch.from_numpy(rng.standard_normal((TRAIN_B, 3, 2 * SR)).astype(np.float32)).to(dev)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=True)
    grads, times, peaks = {}, {}, {}
    for remat in (False, True):
        trainer = Trainer(os.path.join(root, f"remat{remat}"), precision="bfloat16", fused_forward=True,
                          remat=remat, logger=CSVLogger(os.path.join(root, f"remat{remat}", "logs")))
        forward = trainer._train_forward(trainer._make_forward(model), model, 0)
        model.zero_grad(set_to_none=True)
        loss_fn(forward(mix), srcs).backward()
        grads[remat] = [p.grad.clone() for p in model.parameters()]
        opt = make_optimizer(model.parameters(), optim_name="lamb", lr=1e-3, grad_clip=5.0)
        state = {k: v.clone() for k, v in model.state_dict().items()}

        def step():
            opt.zero_grad()
            loss_fn(forward(mix), srcs).backward()
            opt.step()

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[remat] = cuda_time(step, reps=5, warmup=1)
        peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
        model.load_state_dict(state)
        del opt
    same = all(torch.equal(a, b) for a, b in zip(grads[False], grads[True]))
    for remat in (False, True):
        print(f"  train step (fused_forward, lamb) {'with' if remat else 'without'} remat: {times[remat]:.4f} ms "
              f"(median of 5, CUDA events), peak device memory {peaks[remat]:.3f} GiB; {card}")
    print(f"  one step's gradients with remat equal those without, bit for bit: {same}")
    if not same:
        raise AssertionError("remat changed the step's gradients")
    return k2, k3


def optimizer_card_checks(dev) -> None:
    """Phase 37: each optimizer written after optax's rules takes three
    steps on the card (global-norm clipping at 5.0, weight decay 0.01, an LR
    change before the third) and ends within 1e-5 relative of the same
    steps on the CPU, parameter by parameter."""
    from audio_only_speech_separation_tpu_torch.train import make_optimizer, set_learning_rate

    print("phase 37: the optax-rule optimizers on the card against the CPU (3 steps)")
    rng = np.random.default_rng(90)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in OPT_SHAPES]
    p0[1][:] = 0.0
    total = sum(int(np.prod(s)) for s in OPT_SHAPES)
    grads = [[(scale * np.sqrt(27 / total) * rng.standard_normal(s)).astype(np.float32) for s in OPT_SHAPES]
             for scale in (4.0, 0.3, 9.0)]
    worst = {}
    for name in OPTAX_RULES:
        runs = {}
        for where in ("cpu", dev):
            params = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(where)) for p in p0]
            opt = make_optimizer(params, optim_name=name, lr=1e-2, weight_decay=0.01, grad_clip=5.0)
            for i, g in enumerate(grads):
                if i == 2:
                    set_learning_rate(opt, 3e-3)
                for p, gi in zip(params, g):
                    p.grad = torch.from_numpy(gi.copy()).to(where)
                opt.step()
            runs[str(where)] = [p.detach().cpu() for p in params]
        worst[name] = max(float((a - b).norm() / b.norm()) for a, b in zip(runs[str(dev)], runs["cpu"]) if b.norm() > 0)
    print("  worst relative l2, card vs CPU: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (bound 1e-5)")
    if not all(v <= 1e-5 for v in worst.values()):
        raise AssertionError(f"an optimizer's card steps left the CPU's: {worst}")


def mixit_card_checks(dev) -> None:
    """Phase 38: MixIT (both partition modes, with ``return_est``) on the
    card against the CPU: the loss, its gradient and the estimate mixtures
    within 1e-5 relative."""
    from audio_only_speech_separation_tpu_torch.losses import MixITLossWrapper, multisrc_neg_snr

    print("phase 38: MixIT on the card against the CPU")
    rng = np.random.default_rng(91)
    for generalized, n_src, n_mix in ((True, 4, 2), (False, 6, 3)):
        est = (rng.standard_normal((4, n_src, 16000))).astype(np.float32)
        mixes = (rng.standard_normal((4, n_mix, 16000))).astype(np.float32)
        out = {}
        for where in ("cpu", dev):
            e = torch.from_numpy(est).to(where).requires_grad_()
            loss, est_mix = MixITLossWrapper(multisrc_neg_snr, generalized=generalized)(
                e, torch.from_numpy(mixes).to(where), return_est=True)
            loss.backward()
            out[str(where)] = (loss.detach().cpu(), e.grad.cpu(), est_mix.detach().cpu())
        errs = [float((a - b).norm() / b.norm()) for a, b in zip(out[str(dev)], out["cpu"])]
        print(f"  generalized={generalized}, {n_src} estimates, {n_mix} mixtures: relative l2 of the loss "
              f"{errs[0]:.3g}, the gradient {errs[1]:.3g}, the estimate mixtures {errs[2]:.3g} (bound 1e-5)")
        if not all(e <= 1e-5 for e in errs):
            raise AssertionError(f"MixIT on the card differs from the CPU: {errs}")


def two_step_checks(dev, root: str) -> None:
    """Phase 39: the two-step entry on ``configs/tdanet_lrs2.yml``'s model
    at its width (B=2 x 2 s x 16 kHz): step 1 ``audio_train.main`` for two
    steps, then ``audio_train_twostep.main`` warm-started from step 1's
    best_model.pth: the fresh model's ``sm`` parameters are step 1's after
    the merge, bit for bit, and its other parameters are not."""
    from audio_only_speech_separation_tpu_torch import audio_train, audio_train_twostep
    from audio_only_speech_separation_tpu_torch.models import from_pretrain

    print("phase 39: two-step training, TDANet (tdanet_lrs2 width), step 2 warm-started from step 1")
    sr, batch, secs = TRAIN_FAMILIES["TDANet"][2:5]
    work = tempfile.mkdtemp(prefix="twostep_", dir=root)
    data = os.path.join(work, "data")
    n = int(secs * sr)
    write_manifests(data, {"tr": [n] * (TRAIN_STEPS * batch), "cv": [n] * batch, "tt": [n] * batch}, 92,
                    mix="mix", n_src=2, sr=sr)
    merged, real = {}, audio_train_twostep.update_parameter

    def recording(model, state, prefix="sm"):
        copied = real(model, state, prefix)
        merged.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        merged["copied"] = copied
        return copied

    cwd = os.getcwd()
    os.chdir(work)
    audio_train_twostep.update_parameter = recording
    try:
        t0 = time.perf_counter()
        step1 = audio_train.main(train_config("TDANet", data, "twostep1"))
        pretrained = os.path.join(step1, "best_model.pth")
        audio_train_twostep.main(train_config("TDANet", data, "twostep2"), pretrained=pretrained)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        audio_train_twostep.update_parameter = real
        os.chdir(cwd)
    first = {k: v.cpu() for k, v in from_pretrain(pretrained, device=dev).state_dict().items()}
    sm = [k for k in first if k.startswith("sm.")]
    arrived = bool(sm) and all(torch.equal(merged[k], first[k]) for k in sm)
    others_fresh = any(not torch.equal(merged[k], first[k]) for k in first if not k.startswith("sm."))
    print(f"  {run_s:.1f} s; {merged.get('copied')} top-level module copied; {len(sm)} sm tensors arrived "
          f"bit for bit: {arrived}; another parameter left fresh: {others_fresh}")
    if not (merged.get("copied") == 1 and arrived and others_fresh):
        raise AssertionError("the two-step warm start did not carry step 1's sm parameters")
    shutil.rmtree(work, ignore_errors=True)


def new_training_phases(dev, card: str, make_model) -> tuple:
    """Phases 35-39; returns phase 36's (K2, K3) launches."""
    quality_study(card)
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    launched = registry_training(dev, card, scratch.name, make_model)
    optimizer_card_checks(dev)
    mixit_card_checks(dev)
    two_step_checks(dev, scratch.name)
    scratch.cleanup()
    return launched


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels need one")
    from audio_only_speech_separation_tpu_torch import audio_train
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.models import ConvTasNet, from_pretrain, save_serialized
    from audio_only_speech_separation_tpu_torch.models.convtasnet import (
        fused_inference_forward,
        inference_frames,
        make_kernel_train_apply,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels import _build
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import (
        fused_tcn_backward,
        tcn_backward_launches,
        tcn_backward_reference,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
        convtasnet_separator_launches,
        convtasnet_separator_reference,
        fused_convtasnet_separator,
        fused_tcn_separator,
        pack_convtasnet_full_params,
        tcn_chain_reference,
        tcn_separator_launches,
        tcn_separator_reference,
    )
    from audio_only_speech_separation_tpu_torch.serve import serve
    from audio_only_speech_separation_tpu_torch.utils.jax_import import convtasnet_from_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
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
    def serve_and_check(model) -> int:
        """Serve five requests through K1; check each against the f32 module
        and the plain separator; returns K1's launches."""
        rng = np.random.default_rng(4)
        wavs = [rng.standard_normal(int(s * SR)).astype(np.float32) for s in (1.3, 2.0, 2.0, 3.7, 4.0)]
        fused_convtasnet_separator.launches = 0
        est = serve(model, wavs, use_bf16=True, device=dev, bucket_seconds=1.0, batch_size=2)
        torch.cuda.synchronize()
        launches = fused_convtasnet_separator.launches
        n_batches, per_call = 3, convtasnet_separator_launches(LRS3["R"] * LRS3["X"])
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
        return launches

    print("phase 3: serve 5 requests (bf16, 1 s buckets, batch 2)")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "best_model.pth")
        save_serialized({"model_name": "ConvTasNet", "state_dict": random_jax_tree(LRS3, 3),
                         "model_args": LRS3, "infos": {}}, ckpt)
        model = from_pretrain(ckpt, device=dev).eval()
    k1_launches = serve_and_check(model)

    # ---- phase 4: timing at the bench shape
    print(f"phase 4: timing, B=8 x 2 s x 16 kHz, 3 speakers, on {card}")
    model = model_for(LRS3, seed=5)
    packed = pack_convtasnet_full_params(model.state_dict(), 3, 8, 3, device=dev)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 2 * SR)).astype(np.float32)).to(dev)
    frames = inference_frames(model, x)
    frames_bench = frames.shape[1]
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
        k1_kernels = profile_kernels(runs["separator kernel"], 3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    for name, t in ms.items():
        print(f"  {name}: {t:.4f} ms/call, {8 * 2.0 / (t / 1000):.2f} audio-sec/s "
              f"(median of 20, {card})")
    print_kernels("K1", k1_kernels, convtasnet_separator_launches(len(dils)),
                  separator_design_bytes(8, frames_bench), separator_work(8, frames_bench), card)
    del model, packed, frames, w, runs

    # ---- phase 5: K2 vs its plain version at the LRS3 train shape
    T_train = train_frames(2 * SR)
    print(f"phase 5: K2 (TCN chain forward) vs plain, B={TRAIN_B} x T'={T_train}, nb=24, H=512")
    x, w, dils, _ = chain_inputs(dev, 24, 512, TRAIN_B, T_train, seed=7)
    with torch.no_grad():
        y_k, hist_k, st_k = fused_tcn_separator(x, *w, dils, save_state=True)
        again = fused_tcn_separator(x, *w, dils, save_state=True)
        y_p = tcn_separator_reference(x, *w, dils)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "y_hist", "stats"), (y_k, hist_k, st_k), again):
        if not torch.equal(a, b):
            raise AssertionError(f"K2 {name}: two kernel runs differ")
        if not torch.isfinite(a.float()).all():
            raise AssertionError(f"K2 {name}: not finite")
    if not torch.equal(hist_k[:, 0, :T_train], x) or bool(hist_k[:, :, T_train:].any()):
        raise AssertionError("K2 y_hist: slot 0 is not x, or rows >= T' are not zero")
    # Each block against the plain block on the same input (the kernel's
    # saved y_b): atol 5e-2 / rtol 2e-2 for its output y_{b+1} (the next
    # y_hist slot, or y), 1e-3 relative for its statistics.  End to end the
    # two chains drift apart by bf16 rounding over 24 blocks, which the
    # rel-l2 of y bounds.
    k2_excess, k2_stats_rel = -1.0, 0.0
    with torch.no_grad():
        for b in range(len(dils)):
            one = [t[b : b + 1] for t in w]
            y_b, _, st_b = tcn_separator_reference(hist_k[:, b, :T_train], *one, dils[b : b + 1],
                                                   save_state=True)
            got = hist_k[:, b + 1, :T_train] if b + 1 < len(dils) else y_k
            k2_excess = max(k2_excess, float(((got.float() - y_b.float()).abs()
                                              - 2e-2 * y_b.float().abs()).max()))
            k2_stats_rel = max(k2_stats_rel, float(((st_k[:, b] - st_b[:, 0]).abs() / st_b[:, 0].abs()).max()))
    k2_err = max_err(y_k, y_p)
    k2_rel = rel_l2(y_p, y_k)
    print(f"  per block, kernel output vs plain block on the same input: max of |diff| - 2e-2|plain| "
          f"{k2_excess:.6g} (bound 5e-2), stats max relative {k2_stats_rel:.6g} (bound 1e-3)")
    print(f"  end to end: y max abs {k2_err:.6g} (scale {float(y_p.float().abs().max()):.4g}), "
          f"rel-l2 {k2_rel:.6g} (bound 2e-2)")
    if not (k2_excess <= 5e-2 and k2_stats_rel <= 1e-3 and k2_rel <= 2e-2):
        raise AssertionError("K2 differs from its plain version")
    del y_k, hist_k, st_k, again, y_p

    # ---- phase 6: K3 vs its plain version
    print("phase 6: K3 (TCN chain backward) vs autograd of the plain chain")
    names = ("dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas")
    k3_err = None
    for label, (nb, H, B, T), full in (("full width and depth", (24, 512, 2, T_train), True),
                                       ("small", (2, 512, 2, 200), False)):
        x, w, dils, g = chain_inputs(dev, nb, H, B, T, seed=7)
        with torch.no_grad():
            y, y_hist, stats = fused_tcn_separator(x, *w, dils, save_state=True)
            got = fused_tcn_backward(g, y_hist, y, stats, *w, dils)
            again = fused_tcn_backward(g, y_hist, y, stats, *w, dils)
        want = tcn_backward_reference(g, y_hist, y, stats, *w, dils)
        torch.cuda.synchronize()
        rels = {n: rel_l2(c, a) for n, a, c in zip(names, got, want)}
        print(f"  {label} (nb={nb}, H={H}, B={B}, T'={T}): rel-l2 "
              + ", ".join(f"{n} {r:.4g}" for n, r in rels.items()))
        for n, a, b, c in zip(names, got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"K3 {label} {n}: two kernel runs differ")
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"K3 {label} {n}: not finite")
            if full and n == "dalphas":  # the validator's gate for the slopes, the sign as
                # tests/test_tcn_backward.py:172 takes it (of the sum)
                same_sign = float(a.sum()) * float(c.sum()) > 0
                if not (rels[n] <= 0.5 and same_sign):
                    raise AssertionError(f"K3 {label} dalphas: rel {rels[n]}, same sign {same_sign}")
            elif not rels[n] < 6e-2:
                raise AssertionError(f"K3 {label} {n}: rel-l2 {rels[n]} >= 6e-2")
        if not bool((got[3][:, 7] == 0).all()):
            raise AssertionError("K3: dvecs row 7 is not zero")
        if full:
            k3_err = max_err(got[0], want[0])
        del got, again, want, y_hist

    # ---- phase 7: one train step, kernel path vs plain chain vs f32 module
    print("phase 7: one train step at B=2 x 2 s (3 speakers): gradients")
    model = model_for(LRS3, seed=8).train()
    params = dict(model.named_parameters())
    rng = np.random.default_rng(9)
    mix = torch.from_numpy(rng.standard_normal((2, 2 * SR)).astype(np.float32)).to(dev)
    srcs = torch.from_numpy(rng.standard_normal((2, 3, 2 * SR)).astype(np.float32)).to(dev)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=True)

    def grads(fn, bf16: bool):
        p = {k: v.to(torch.bfloat16) for k, v in params.items()} if bf16 else params
        est = fn(p, mix.to(torch.bfloat16) if bf16 else mix)
        loss = loss_fn(est.float(), srcs)
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    l_k, g_k = grads(make_kernel_train_apply(model), True)
    l_p, g_p = grads(make_kernel_train_apply(model, chain=tcn_chain_reference), True)
    l_f, g_f = grads(lambda p, m: model(m), False)
    print(f"  loss: kernel {l_k:.6g}, plain chain {l_p:.6g}, f32 module {l_f:.6g}")
    # Each parameter tensor within rel-l2 0.1 of the plain chain's gradient.
    # The 48 scalar PReLU slopes are held as one vector, as K3 returns them
    # (dalphas): each is a sum over B*T'*H terms that cancel, so a single
    # slope's bf16 gradient is noise-dominated (the plain chain's own one
    # differs from the f32 module's by up to about 100%, printed below).
    slopes = [i for i, n in enumerate(params) if ".prelu" in n]
    tensors = [i for i in range(len(params)) if i not in slopes]
    names_p = list(params)
    worst = max((rel_l2(g_p[i], g_k[i]), names_p[i]) for i in tensors)
    s_k, s_p, s_f = (torch.cat([gs[i].flatten() for i in slopes]) for gs in (g_k, g_p, g_f))
    s_rel = rel_l2(s_p, s_k)
    print(f"  per parameter tensor, kernel vs plain chain: worst rel-l2 {worst[0]:.4g} ({worst[1]}); "
          f"{len(slopes)} PReLU slopes together: {s_rel:.4g} (bounds 0.1)")
    print(f"  slopes, one at a time: worst rel error kernel vs plain "
          f"{float(((s_k - s_p).abs() / s_p.abs()).max()):.4g}, plain vs f32 "
          f"{float(((s_p - s_f).abs() / s_f.abs()).max()):.4g} (not gated)")
    if not (worst[0] < 0.1 and s_rel < 0.1):
        raise AssertionError(f"train step: gradient rel-l2 {worst} / slopes {s_rel} >= 0.1")
    flat = [torch.cat([t.flatten().float() for t in gs]) for gs in (g_k, g_p, g_f)]
    e_k, e_p, n_f = float((flat[0] - flat[2]).norm()), float((flat[1] - flat[2]).norm()), float(flat[2].norm())
    bound = 1.5 * e_p + 1e-3 * n_f
    print(f"  all gradients: |kernel - f32| {e_k:.6g}, |plain - f32| {e_p:.6g}, |f32| {n_f:.6g}, "
          f"bound {bound:.6g}")
    if not e_k <= bound:
        raise AssertionError(f"train step gradients: {e_k} > 1.5 * {e_p} + 1e-3 * {n_f}")
    del model, params, g_k, g_p, g_f, flat

    # ---- phase 8: the training CLI, then serve what it wrote
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")  # phases 8 and 18
    print(f"phase 8: audio_train.main on synthetic LRS3 manifests (3 spk, 2 s, batch {TRAIN_B})")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_manifests(os.path.join(tmp, "data"),
                        {"tr": [2 * SR] * 3 * TRAIN_B, "cv": [2 * SR] * TRAIN_B, "tt": [2 * SR] * TRAIN_B}, 10)
        fused_tcn_separator.launches = fused_tcn_backward.launches = 0
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            exp_dir = audio_train.main(lrs3_train_config(os.path.join(tmp, "data"), epochs=1))
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        k2_launches, k3_launches = fused_tcn_separator.launches, fused_tcn_backward.launches
        with open(os.path.join(tmp, "Experiments", "tensorboard_logs", "ConvTasNet-LRS33SPK-smoke",
                               "scalars.csv")) as f:
            scalars = {row.split(",")[1]: float(row.split(",")[2]) for row in f.read().splitlines()[1:]}
        steps = 3
        # per train step one K2 and one K3 call; eval (cv + tt) one K2 call per batch
        want_k2, want_k3 = (steps + 2) * tcn_separator_launches(24), steps * tcn_backward_launches(24)
        print(f"  {train_s:.1f} s; train_loss {scalars['train_loss']:.6g}, val_loss "
              f"{scalars['val_loss']:.6g}; K2 launches {k2_launches} (want {want_k2}), "
              f"K3 launches {k3_launches} (want {want_k3})")
        if (k2_launches, k3_launches) != (want_k2, want_k3):
            raise AssertionError("the training run did not go through K2 and K3 as counted")
        if not all(np.isfinite(scalars[k]) for k in ("train_loss", "val_loss", "test_loss")):
            raise AssertionError(f"non-finite losses: {scalars}")
        model = from_pretrain(os.path.join(exp_dir, "best_model.pth"), device=dev).eval()
        print("  serving best_model.pth through K1:")
        serve_and_check(model)
        del model
        lrs3_exp = shutil.copytree(exp_dir, os.path.join(scratch.name, "lrs3_exp"))  # phase 18 evaluates it

    # ---- phase 9: train-step timing, and K2/K3 alone
    def train_timings(batch: int):
        model = model_for(LRS3, seed=11).train()
        params = dict(model.named_parameters())
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        rng = np.random.default_rng(12)
        mix = torch.from_numpy(rng.standard_normal((batch, 2 * SR)).astype(np.float32)).to(dev)
        srcs = torch.from_numpy(rng.standard_normal((batch, 3, 2 * SR)).astype(np.float32)).to(dev)
        kernel_fn = make_kernel_train_apply(model)
        plain_fn = make_kernel_train_apply(model, chain=tcn_chain_reference)

        def step(fn, bf16):
            def run():
                opt.zero_grad(set_to_none=True)
                if bf16:
                    est = fn({k: v.to(torch.bfloat16) for k, v in params.items()}, mix.to(torch.bfloat16))
                else:
                    est = model(mix)
                loss_fn(est.float(), srcs).backward()
                torch.nn.utils.clip_grad_norm_(model.parameters(), 5.0)
                opt.step()
            return run

        out = {
            "train step, kernel path": cuda_time(step(kernel_fn, True), reps=10),
            "train step, plain bf16 path": cuda_time(step(plain_fn, True), reps=5, warmup=1),
            "train step, f32 eager module": cuda_time(step(None, False), reps=5, warmup=1),
        }
        x, w, dils, g = chain_inputs(dev, 24, 512, batch, T_train, seed=13)
        with torch.no_grad():
            y, y_hist, stats = fused_tcn_separator(x, *w, dils, save_state=True)
            out["K2 kernel"] = cuda_time(lambda: fused_tcn_separator(x, *w, dils, save_state=True), reps=10)
            out["K2 plain"] = cuda_time(lambda: tcn_separator_reference(x, *w, dils, save_state=True), reps=5)
            k2_kernels = profile_kernels(lambda: fused_tcn_separator(x, *w, dils, save_state=True), 3)
            out["K3 kernel"] = cuda_time(lambda: fused_tcn_backward(g, y_hist, y, stats, *w, dils), reps=10)
            k3_kernels = profile_kernels(lambda: fused_tcn_backward(g, y_hist, y, stats, *w, dils), 3)
        out["K3 plain"] = cuda_time(lambda: tcn_backward_reference(g, y_hist, y, stats, *w, dils), reps=3, warmup=1)
        return out, k2_kernels, k3_kernels

    print(f"phase 9: train-step and K2/K3 timing, LRS3 full model, 2 s, on {card}")
    batch = TRAIN_B
    try:
        ms9, k2_kernels, k3_kernels = train_timings(batch)
    except torch.cuda.OutOfMemoryError:
        ms9 = None  # retried below, once the failed attempt's tensors are freed
    if ms9 is None:
        torch.cuda.empty_cache()
        batch = 4
        print(f"  out of memory at B={TRAIN_B}; all of phase 9 at B={batch}")
        ms9, k2_kernels, k3_kernels = train_timings(batch)
    for name, t in ms9.items():
        print(f"  {name}: {t:.4f} ms (B={batch} x 2 s, median, CUDA events, {card})")
    print_kernels("K2", k2_kernels, tcn_separator_launches(24), chain_design_bytes(batch, T_train),
                  chain_work(batch, T_train), card)
    print(f"  K3 by kernel (torch.profiler, per call of {tcn_backward_launches(24)} launches, {card}): "
          + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]:g} launches)" for k, v in k3_kernels.items()))
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    k4_err, k5_err, k6_err = dualpath_kernel_checks(dev)
    tasnets = {"DPTNet": tasnet_model("DPTNet", 21, dev), "DPRNN": tasnet_model("DPRNN", 22, dev)}
    k4_launches, k5_launches, k6_launches = tasnet_serving(dev, tasnets)
    k4, k5, k6 = tasnet_timing(dev, card, tasnets)

    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    sepformer = sepformer_model(31, dev)
    k4_err = max(k4_err, sepformer_checks(dev, sepformer))
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    with open(os.path.join(lrs3_exp, "conf.yml")) as f:  # JSON, written by audio_train.main
        lrs3_conf = json.load(f)
    launched = eval_cli_checks(dev, scratch.name, "phase 18: the eval CLI on the card", {
        "(a) ConvTasNet-LRS3": (lrs3_exp, None, lrs3_conf["audionet"], "LRS3DataModule", 3, SR, ("K1",), (),
                                "fused"),
        "(b) DPTNet wsj0": (None, tasnets["DPTNet"], {"audionet_name": "TasNet", "audionet_config": dict(
            {k: v for k, v in WSJ0_TASNET.items() if k != "sample_rate"}, module="DPTNet")},
            "LRS2DataModule", 2, TSR, ("K4", "K5", "K6"), (), "kernels"),
        "(c) Sepformer": (None, sepformer, {"audionet_name": "Sepformer", "audionet_config": dict(SEPFORMER)},
                          "LRS2DataModule", 2, SR, ("K4",), (), "kernels"),
    })
    scratch.cleanup()
    # K4 on the main paths: DPTNet served (phase 15) and the Sepformer through the eval CLI (phase 18)
    k4_launches += launched["(c) Sepformer"]["K4"]
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    sepformer_timing(dev, card, sepformer)
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")

    from audio_only_speech_separation_tpu_torch.models import AFRCNN, BSRNN, TDANet

    bsrnn = seeded_model(BSRNN, BSRNN_WSJ0, TSR, 41, dev)
    k5_bsrnn_err, k6_bsrnn_err, _ = bsrnn_checks(dev, bsrnn)
    k5_err, k6_err = max(k5_err, k5_bsrnn_err), max(k6_err, k6_bsrnn_err)
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    tdanet = seeded_model(TDANet, TDANET_LRS2, SR, 42, dev)
    k4_tdanet_err, k4_tdanet_launches = tdanet_checks(dev, tdanet)
    k4_err = max(k4_err, k4_tdanet_err)
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    afrcnn = seeded_model(AFRCNN, AFRCNN_LRS2, SR, 43, dev)
    afrcnn_checks(dev, afrcnn)
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    launched = eval_cli_checks(dev, scratch.name, "phase 23: the eval CLI on the card for the three new models", {
        "(d) BSRNN wsj0": (None, bsrnn, {"audionet_name": "BSRNN", "audionet_config": dict(BSRNN_WSJ0)},
                           "LRS2DataModule", 2, TSR, ("K5", "K6"), ("K4",), "kernels"),
        "(e) TDANet LRS2": (None, tdanet, {"audionet_name": "TDANet", "audionet_config": dict(TDANET_LRS2)},
                            "LRS2DataModule", 2, SR, (), ("K4", "K5", "K6"), "fast_tdanet"),
        "(f) AFRCNN LRS2": (None, afrcnn, {"audionet_name": "AFRCNN", "audionet_config": dict(AFRCNN_LRS2)},
                            "LRS2DataModule", 2, SR, (), ("K4", "K5", "K6"), "kernels"),
    })
    scratch.cleanup()
    # K4 on TDANet's module path (phase 21); K5 and K6 through the eval CLI's BSRNN (phase 23)
    k4_launches += k4_tdanet_launches
    k5_launches += launched["(d) BSRNN wsj0"]["K5"]
    k6_launches += launched["(d) BSRNN wsj0"]["K6"]
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    new_models_timing(dev, card, bsrnn, tdanet, afrcnn)
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    del bsrnn, tdanet, afrcnn, tasnets, sepformer
    torch.cuda.empty_cache()

    k7 = micro_vpu_checks(card)
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")  # phases 26-28
    print("phase 26: one bf16 train step of DPRNN, DPTNet and BSRNN three ways (kernels, plain versions, f32)")
    train_step_checks(dev, scratch.name, ("DPRNN", "DPTNet", "BSRNN"))
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    trained = train_cli_checks(dev, scratch.name)
    k4_launches, k5_launches, k6_launches = (k4_launches + trained["K4"], k5_launches + trained["K5"],
                                             k6_launches + trained["K6"])
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    train_timing(dev, card, scratch.name)
    scratch.cleanup()
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")

    zoo, zoo_launched, zoo_errs = zoo_checks(dev)
    k4_err, k5_err, k6_err = (max(a, b) for a, b in zip((k4_err, k5_err, k6_err), zoo_errs))
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    cli_launched = zoo_eval_cli(dev, zoo)
    # the new models' kernel paths (phases 29-31) and the eval CLI on them (phase 32)
    k4_launches, k5_launches, k6_launches = (n + a + b for n, a, b in zip(
        (k4_launches, k5_launches, k6_launches), zoo_launched, cli_launched))
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    zoo_timing(dev, card, zoo)
    del zoo
    torch.cuda.empty_cache()
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    scratch = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    print("phase 34: one bf16 train step of Sandglasset and DPRNNTasNet three ways (kernels, plain versions, f32)")
    train_step_checks(dev, scratch.name, tuple(STEP_FAMILIES))
    scratch.cleanup()
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")
    k2_remat, k3_remat = new_training_phases(dev, card, lambda: model_for(LRS3, seed=82))
    k2_launches, k3_launches = k2_launches + k2_remat, k3_launches + k3_remat
    print(f"  {time.perf_counter() - t_start:.1f} s since the start")

    k1_b, k1_by = least_time(*separator_work(8, frames_bench))
    k2_b, k2_by = least_time(*chain_work(batch, T_train))
    k3_b, k3_by = least_time(*chain_work(batch, T_train, products=5))

    print(json.dumps({"kernels": [
        {"name": "convtasnet_separator", "route": "cuda", "source": CSRC + "convtasnet_separator.cu",
         "replaces": PALLAS + "convtasnet_block.py:74", "launches": k1_launches,
         "max_abs_err": errs["lrs3"], "ms": ms["separator kernel"], "plain_ms": ms["separator plain"],
         "bound_ms": k1_b, "bound_by": k1_by, "library_ms": None},
        {"name": "tcn_separator", "route": "cuda", "source": CSRC + "convtasnet_separator.cu",
         "replaces": PALLAS + "convtasnet_block.py:801", "launches": k2_launches,
         "max_abs_err": k2_err, "ms": ms9["K2 kernel"], "plain_ms": ms9["K2 plain"],
         "bound_ms": k2_b, "bound_by": k2_by, "library_ms": None},
        {"name": "tcn_backward", "route": "cuda", "source": CSRC + "convtasnet_backward.cu",
         "replaces": PALLAS + "convtasnet_backward.py:145", "launches": k3_launches,
         "max_abs_err": k3_err, "ms": ms9["K3 kernel"], "plain_ms": ms9["K3 plain"],
         "bound_ms": k3_b, "bound_by": k3_by, "library_ms": None},
        {"name": "attention_bdt", "route": "cuda", "source": CSRC + "attention.cu",
         "replaces": PALLAS + "attention.py:43", "launches": k4_launches, "max_abs_err": k4_err,
         **{key: k4[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "lstm_recurrence", "route": "cuda", "source": CSRC + "lstm.cu",
         "replaces": PALLAS + "lstm.py:42", "launches": k5_launches, "max_abs_err": k5_err,
         **{key: k5[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "lstm_resident", "route": "cuda", "source": CSRC + "lstm.cu",
         "replaces": PALLAS + "lstm.py:211", "launches": k6_launches, "max_abs_err": k6_err,
         **{key: k6[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        k7,
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
