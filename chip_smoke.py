#!/usr/bin/env python3
"""Smoke run of the port's hand-written kernels on their main paths, on one
NVIDIA GPU, and the helpers the on-card profile scripts import.

    python3 chip_smoke.py

Drives each path once, its launch counters set to 0 just before it:

- ConvTasNet-LRS3 served at B=8 x 2 s (the ``convtasnet_lrs3.serve_b8_2s``
  cell, ``Server``'s "fused" dispatch): 50 launches of K1;
- one bf16 train step of ConvTasNet-LRS3 at B=12 x 2 s (the
  ``convtasnet_lrs3.train_b12_2s`` cell's fused form): K2 in the forward,
  K3 in the backward;
- Sepformer (sepformer_base) served at B=8 x 2 s (the
  ``sepformer_base.serve_b8_2s`` cell, "kernels"): 32 launches of K4's
  packed entry, none of its [BH, dh, T] entry, 68 of K8;
- the wsj0 DPTNet served at B=1 x 12 s x 8 kHz ("kernels"): 12 of K4's
  packed entry, 6 of K5 and 6 of K6;
- Sandglasset served at B=8 x 2 s x 8 kHz ("kernels"): 2 of K4's
  [BH, dh, T] entry (its 4-D blocks), 4 of the packed entry, 6 of K6,
  15 gLNs of K9 (then K9 alone at the Sandglasset cell's four gLN shapes);
- BSRNN-WSJ0 served at B=1 x 6 s x 8 kHz (the
  ``bsrnn_wsj0.serve_b1_wsj0len`` cell, "kernels"): 8 of K5 at
  (751, 2, 8, 256) and 8 of K6 at (8, 751, 128, 256, 2);
- K7 at its probe's [2048, 512] in bf16 with statistics (no model serves it).

Each path asserts its exact launches and that no plain version of a kernel
ran; its output meets the 1.5x rule against the f32 module (the train step:
its gradients meet PERF.md section 2's rule).  Then each kernel is held
against its plain version on the same inputs at each shape the path gave
it, and timed beside it (CUDA events, median of 20; the plain version of
3), beside a library call where one computes the same (SDPA, a bf16
``nn.LSTM``) and its least time (``port_bench/bounds.py``; K5's and K6's
work from ``port_bench/lstm_work.py``, as the cell's rooflines count it).
Prints one JSON line ``{"kernels": [...]}``, an entry per kernel and shape,
the card's name and power limit, and ``{"ok": true, "device": ...}``.  Raises on any
failure.  The port's on-card test suite is the ``cuda``-marked tests
(``.claude/skills/verify/SKILL.md`` names the command); this run is the
one-call account of the kernels on the benchmark's paths.

The rest is imported: the published widths, seeded models and the rules
from ``tests/torch_port_card.py`` (one copy, which the card tests use),
re-exported for ``scripts/profile_port_{block_body,dualpath,micro_vpu,
train_quality}.py``; ``train_frames``, ``least_time`` (in ms),
``separator_work`` and ``chain_work`` (``port_bench/bounds.py``'s) for
``port_bench/tests/test_port_bench_bounds.py``.  It imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))

from port_bench.attention_work import attention_work  # noqa: E402
from port_bench.bounds import PEAK_BYTES, chain_work, separator_work  # noqa: E402,F401 (re-exported)
from port_bench.bounds import least_time as _least_seconds  # noqa: E402
from port_bench.lstm_work import recurrence_work, resident_work  # noqa: E402
from torch_port_card import (  # noqa: E402,F401 (re-exported for the profile scripts)
    BSRNN_WSJ0,
    LRS3,
    SEPFORMER,
    SANDGLASSET,
    SANDGLASSET_K9,
    SEPFORMER_K4,
    SEPFORMER_K8,
    SR,
    TRAIN_B,
    TSR,
    convtasnet_model,
    counting_plain_versions,
    dualpath_paths,
    flat,
    gradients_meet_the_rule,
    kernel_cases,
    max_err,
    meets_the_rule,
    rand_maker,
    recording_kernel_shapes,
    seeded_model,
    tasnet_model,
    waves,
)

CSRC = "audio_only_speech_separation_tpu_torch/csrc/"
PALLAS = "audio_only_speech_separation_tpu/ops/pallas/"


def least_time(nbytes: float, flops: float):
    """``port_bench/bounds.py::least_time`` in ms: (least ms the card could
    take, "bytes" or "operations")."""
    t, by = _least_seconds(nbytes, flops)
    return t * 1e3, by


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


def train_frames(T: int, L: int = 16) -> int:
    """T' of the model's framing for T samples (models/convtasnet.py::_pads)."""
    win, pad_stride = L, L // 2
    rest = win - (pad_stride + T % win) % win
    return (T + rest + 2 * (win - pad_stride) - win) // (L // 4) + 1


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


def _zeroed(*counters):
    """``counters`` (kernel wrappers) with their launches set to 0."""
    for c in counters:
        c.launches = 0
    return counters


def _held(kernel, plain, args):
    """(kernel's output, plain version's) on ``args``; the kernel's finite
    and bit-identical from run to run."""
    with torch.no_grad():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(*((t,) if torch.is_tensor(t) else t for t in (got, again))):
        assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
    return got, want


def _entry(name, source, replaces, shape, launches, err, kernel, plain, args, work, library=None):
    """One entry of the kernels line: the kernel and its plain version on
    ``args`` timed, its least time from ``work`` (bytes, FLOPs), the
    library call's time where there is one."""
    def timed(fn, reps=20):
        with torch.no_grad():
            return cuda_time(fn, reps, warmup=3)

    bound, by = least_time(*work)
    return {"name": name, "route": "cuda", "source": CSRC + source, "replaces": PALLAS + replaces if replaces else None,
            "shape": list(shape), "launches": launches, "max_abs_err": err, "ms": timed(lambda: kernel(*args)),
            "plain_ms": timed(lambda: plain(*args), 3), "bound_ms": bound, "bound_by": by,
            "library_ms": None if library is None else timed(library)}


def convtasnet_serve(dev) -> list:
    """K1 on the ConvTasNet serve cell's path; K1 within ``K1_PLAIN_REL`` of
    its plain version's largest magnitude on the path's frames."""
    from audio_only_speech_separation_tpu_torch.bench import K1_PLAIN_REL
    from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward, inference_frames
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_block as k1
    from audio_only_speech_separation_tpu_torch.serve import Server

    model = convtasnet_model(LRS3, 1, dev)
    server = Server(model, True, dev)
    assert server.dispatch == "fused", server.dispatch
    x = waves(dev, 2, 8, 2 * SR)
    (counter,) = _zeroed(k1.fused_convtasnet_separator)
    got = server.forward(x)
    torch.cuda.synchronize()
    launches = counter.launches
    assert launches == k1.convtasnet_separator_launches(model.R * model.X), launches
    with torch.no_grad():
        plain = fused_inference_forward(model, x.to(torch.bfloat16), packed=server.packed,
                                        separator=k1.convtasnet_separator_reference)
        meets_the_rule(got, model(x), plain, "ConvTasNet-LRS3 served")
    *w, dils = server.packed
    frames = inference_frames(model, x)
    kernel, reference = ((lambda f, sep=sep: sep(f, *w, dilations=dils, nspk=model.num_spks))
                         for sep in (k1.fused_convtasnet_separator, k1.convtasnet_separator_reference))
    sep, sep_plain = _held(kernel, reference, (frames,))
    err = max_err(sep, sep_plain)
    assert err <= K1_PLAIN_REL * float(sep_plain.float().abs().max()), err
    return [_entry("convtasnet_separator", "convtasnet_separator.cu", "convtasnet_block.py:74", frames.shape,
                   launches, err, kernel, reference, (frames,), separator_work(*frames.shape[:2]))]


def convtasnet_train(dev) -> list:
    """K2 and K3 on the ConvTasNet train cell's step, then each against its
    plain version on the validator's chain inputs at the step's shape:
    K2's output within rel-l2 2e-2, each of K3's cotangents within 6e-2 (the
    PReLU slopes' within the JAX validator's 0.5, of the same sign)."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_backward as k3
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_block as k2
    from audio_only_speech_separation_tpu_torch.train.trainer import bf16_forward

    model = convtasnet_model(LRS3, 8, dev).train()
    params = list(model.parameters())
    mix, srcs = waves(dev, 9, TRAIN_B, 2 * SR), waves(dev, 10, 3 * TRAIN_B, 2 * SR).view(TRAIN_B, 3, -1)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx", threshold_byloss=True)

    def grads(forward):
        return flat(torch.autograd.grad(loss_fn(forward(mix), srcs), params))

    nb = model.R * model.X
    fwd, bwd = _zeroed(k2.fused_tcn_separator, k3.fused_tcn_backward)
    g = grads(bf16_forward(model, True))
    torch.cuda.synchronize()
    launched = fwd.launches, bwd.launches
    assert launched == (k2.tcn_separator_launches(nb), k3.tcn_backward_launches(nb)), launched
    gradients_meet_the_rule(g, grads(bf16_forward(model, True, chain=k2.tcn_chain_reference)), grads(model),
                            "ConvTasNet-LRS3 train step")
    del g
    x, w, dils, cot = chain_inputs(dev, nb, LRS3["H"], TRAIN_B, train_frames(2 * SR), 5)
    k2_pair = (lambda a: k2.fused_tcn_separator(a, *w, dils), lambda a: k2.tcn_separator_reference(a, *w, dils))
    y, y_plain = _held(*k2_pair, (x,))
    assert rel_l2(y_plain, y) <= 2e-2, rel_l2(y_plain, y)
    y_saved, y_hist, stats = k2.fused_tcn_separator(x, *w, dils, save_state=True)
    k3_pair = (lambda *a: k3.fused_tcn_backward(*a, *w, dils), lambda *a: k3.tcn_backward_reference(*a, *w, dils))
    args = (cot, y_hist, y_saved, stats)
    got, want = _held(*k3_pair, args)
    for name, a, b in zip(("dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas"), got, want):
        ok = rel_l2(b, a) <= 0.5 and float(a.sum()) * float(b.sum()) > 0 if name == "dalphas" else rel_l2(b, a) < 6e-2
        assert ok, (name, rel_l2(b, a))
    B, T = x.shape[:2]
    return [_entry("tcn_separator", "convtasnet_separator.cu", "convtasnet_block.py:801", x.shape, launched[0],
                   max_err(y, y_plain), *k2_pair, (x,), chain_work(B, T, nb)),
            _entry("tcn_backward", "convtasnet_backward.cu", "convtasnet_backward.py:145", x.shape, launched[1],
                   max(max_err(a, b) for a, b in zip(got, want)), *k3_pair, args, chain_work(B, T, nb, products=5))]


def _dualpath_costs(name, shape, args):
    """(source, pallas line, (bytes, FLOPs), library call or None) of one
    of ``kernel_cases``' cases."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if name == "attention_bdt":
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in args)
        return "attention.cu", "attention.py:43", attention_work(*shape), lambda: sdpa(qt, kt, vt)
    if name == "attention_packed":
        B, T, E3, h = shape
        q, k, v = (a.reshape(B, T, h, E3 // (3 * h)).transpose(1, 2).contiguous() for a in args[0].chunk(3, -1))
        return "attention.cu", "attention.py:43", attention_work(B * h, E3 // (3 * h), T), lambda: sdpa(q, k, v)
    if name == "lstm_recurrence":
        return "lstm.cu", "lstm.py:42", recurrence_work(*shape), None
    T, B, Din, H, D = shape
    lib = torch.nn.LSTM(Din, H, batch_first=True, bidirectional=D == 2).to(args[0].device, torch.bfloat16)
    lib.flatten_parameters()
    return "lstm.cu", "lstm.py:211", resident_work(*shape), lambda: lib(args[0])


def dualpath_serve(dev, label, model, x, want) -> list:
    """K4 (both entries), K5 and K6 on ``model``'s "kernels" serving of
    ``x``: ``want`` launches of (K4 [BH, dh, T], K4 packed, K5, K6); then
    each (``kernel_cases``) against its plain version at each shape the
    call gave it."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import attention as k4
    from audio_only_speech_separation_tpu_torch.ops.kernels import lstm

    kernel, plain, f32 = dualpath_paths(model)
    counters = _zeroed(k4.fused_attention_bdt, k4.fused_attention_packed, lstm.fused_bilstm, lstm.resident_bilstm)
    with counting_plain_versions() as plain_calls, recording_kernel_shapes() as shapes:
        got = kernel(x)
        torch.cuda.synchronize()
    launched = dict(zip(("attention_bdt", "attention_packed", "lstm_recurrence", "lstm_resident"),
                        (c.launches for c in counters)))
    assert tuple(launched.values()) == want and not any(plain_calls.values()), (label, launched, plain_calls)
    meets_the_rule(got, f32(x), plain(x), label)
    packed_as_bdt = {(B * h, E3 // (3 * h), T) for B, T, E3, h in shapes["K4 packed"]}  # noted under "K4" too
    entries = []
    for name, shape, kernel, plain, args, limit in kernel_cases(dev, dict(shapes, K4=shapes["K4"] - packed_as_bdt)):
        out, ref = _held(kernel, plain, args)
        assert max_err(out, ref) < limit, (label, name, shape, max_err(out, ref))
        source, replaces, work, library = _dualpath_costs(name, shape, args)
        entries.append(_entry(name, source, replaces, shape, launched[name], max_err(out, ref), kernel, plain, args,
                              work, library))
    return entries


def add_norm_entries(dev, sepformer_path) -> list:
    """``sepformer_path()``'s entries with its 68 K8 launches counted from 0;
    then K8's residual form at the cell's two stack shapes: s the plain add, h
    within 2e-2 of the plain LayerNorm, timed beside them (``device_ms``: under
    the profiler)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import add_layer_norm as k8
    from port_bench.addnorm_work import addnorm_work

    (counter,), rand = _zeroed(k8.add_layer_norm_launches), rand_maker(92, dev)
    entries, launches = sepformer_path(), counter.launches
    assert launches == SEPFORMER_K8, launches
    for B, T, d in ((272, 250, 256), (2000, 34, 256)):
        args = (rand((B, T, d)), rand((B, T, d)), 1 + rand((d,), 0.2), rand((d,), 0.1), 1e-6)
        (s, h), (s_ref, h_ref) = _held(k8.fused_add_layer_norm, k8.add_layer_norm_reference, args)
        assert torch.equal(s, s_ref) and max_err(h, h_ref) < 2e-2, (B, T, max_err(h, h_ref))
        entry = _entry("add_layer_norm", "add_layer_norm.cu", None, (B, T, d), launches, max_err(h, h_ref),
                       k8.fused_add_layer_norm, k8.add_layer_norm_reference, args, addnorm_work(B * T, d, B * T, True))
        ops = profile_kernels(lambda: k8.fused_add_layer_norm(*args), 20)
        entries.append(dict(entry, device_ms=sum(ms for k, (ms, _) in ops.items() if "add_layer_norm" in k)))
    return entries


def gln_entries(dev, sandglasset_path) -> list:
    """``sandglasset_path()``'s entries with its 15 K9 gLNs counted from 0;
    then K9 at the Sandglasset cell's four gLN shapes (8 x 4.0 s): within
    2e-2 of its plain version, timed beside it (``device_ms``: both passes
    under the profiler)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import global_layer_norm as k9
    from port_bench.gln_work import gln_work

    (counter,), rand = _zeroed(k9.global_layer_norm_launches), rand_maker(93, dev)
    entries, launches = sandglasset_path(), counter.launches
    assert launches == SANDGLASSET_K9, launches
    for shape, residual in (((8, 259, 250, 128), True), ((8, 259, 250, 128), False), ((8, 32002, 64), False),
                            ((16, 32002, 64), False)):
        C = shape[-1]
        args = (rand(shape, 2.0), 1 + rand((C,), 0.2), rand((C,), 0.1), 1e-5, rand(shape) if residual else None)
        y, y_ref = _held(k9.fused_global_layer_norm, k9.global_layer_norm_reference, args)
        assert max_err(y, y_ref) < 2e-2, (shape, max_err(y, y_ref))
        entry = _entry("global_layer_norm", "global_layer_norm.cu", None, shape + (residual,), launches,
                       max_err(y, y_ref), k9.fused_global_layer_norm, k9.global_layer_norm_reference, args,
                       gln_work(shape[0], y[0].numel(), residual))
        ops = profile_kernels(lambda: k9.fused_global_layer_norm(*args), 20)
        entries.append(dict(entry, device_ms=sum(ms for k, (ms, _) in ops.items() if k.startswith("gln_"))))
    return entries


def micro_vpu_probe() -> list:
    """K7 at its probe's [2048, 512] in bf16 with statistics: bit-equal to
    its plain version, the sum of squares within 1e-5 relative; its timed
    case (200 calls in a CUDA graph after one) launches once a call."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import micro_vpu as k7
    from audio_only_speech_separation_tpu_torch.ops.kernels._build import load_library

    x = k7.bench_input(torch.bfloat16)
    (got, total), (want, want_total) = _held(lambda a: k7.micro_vpu(a, True, return_stats=True),
                                             lambda a: k7.micro_vpu_reference(a, True, return_stats=True), (x,))
    assert torch.equal(got, want) and abs(float(total) / float(want_total) - 1) <= 1e-5
    (counter,) = _zeroed(k7.micro_vpu)
    us = k7.bench(torch.bfloat16, True)["us"]
    torch.cuda.synchronize()
    assert counter.launches == 201 * load_library().micro_vpu_launches(1), counter.launches
    bound, by = micro_vpu_bounds()[torch.bfloat16, True]
    return [{"name": "micro_vpu", "route": "cuda", "source": CSRC + "micro_vpu.cu",
             "replaces": "scripts/micro_vpu.py:22", "shape": list(x.shape), "launches": counter.launches,
             "max_abs_err": 0.0, "ms": us / 1e3,
             "plain_ms": cuda_time(lambda: k7.micro_vpu_reference(x, True), reps=5), "bound_ms": bound,
             "bound_by": by, "library_ms": None}]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references are full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_identity()
    kernels = convtasnet_serve(dev) + convtasnet_train(dev)
    kernels += add_norm_entries(dev, lambda: dualpath_serve(dev, "Sepformer B=8 x 2 s", seeded_model(
        "Sepformer", SEPFORMER, SR, 90, dev), waves(dev, 98, 8, 2 * SR), (0, SEPFORMER_K4, 0, 0)))
    kernels += dualpath_serve(dev, "DPTNet B=1 x 12 s", tasnet_model("DPTNet", 21, dev), waves(dev, 23, 1, 12 * TSR),
                              (0, 12, 6, 6))
    kernels += gln_entries(dev, lambda: dualpath_serve(dev, "Sandglasset B=8 x 2 s", seeded_model(
        "Sandglasset", SANDGLASSET, TSR, 94, dev), waves(dev, 98, 8, 2 * TSR), (2, 4, 0, 6)))
    kernels += dualpath_serve(dev, "BSRNN B=1 x 6 s", seeded_model("BSRNN", BSRNN_WSJ0, TSR, 95, dev),
                              waves(dev, 99, 1, 6 * TSR), (0, 0, 8, 8))
    kernels += micro_vpu_probe()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
