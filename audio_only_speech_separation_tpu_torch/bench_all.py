"""The inference sweep of every model family on one card (counterpart of
``scripts/bench_all.py``, with ``scripts/bench_kernel_only.py`` as its last
row): bf16, 2 s clips at each model's rate, through the path that
``serve.Server`` sets up.

    python -m audio_only_speech_separation_tpu_torch.bench_all [--only S] [--iters N] [--out FILE]
    python -m audio_only_speech_separation_tpu_torch.bench_all --device cpu --only DPRNN --batch 1 --seconds 0.1 --iters 1

The 11 cases of ``scripts/bench_all.py:26-44`` at the same widths, rates
and batches, and "K2 alone": the TCN chain kernel (ConvTasNet-LRS3's 24
blocks) on bf16 [8, 8008, 128], as ``scripts/bench_kernel_only.py`` runs
it.  Each row names its path: "fused" (K1), "fast_tdanet", "kernels" (the
bf16 copy of the module, whose attention and LSTM layers take K4, K5 and
K6), or "k2".  The ConvTasNet and TDANet module rows force "kernels" where
``serve.choose_dispatch`` would pick "fused" or "fast_tdanet".

Timing: the weights cast or packed once, one warm-up call, then ``--iters``
calls back to back between two CUDA events.  Each row prints ms a call,
audio-seconds a second, the parameter count, GFLOP per audio-second, the
share of the H100's bf16 dense peak (989 TFLOP/s) and the kernel launches
a call.  The FLOPs are ``utils/profiling.estimate_cost``'s count of one
call of the same path inside ``ops.kernels.plain_versions()`` (the plain
K1/K2 separator for "fused"/"k2"): ``FlopCounterMode`` does not see the
kernels' launches, so a count on the kernel path would read low.

A case that raises prints FAILED and the sweep goes on; the process then
exits with 1.  There is no fallback to another dtype or mode.  ``--out``
writes the markdown table to the file named (no default).  ``--device
cpu`` (with ``--batch``/``--seconds`` to shrink the cases) runs the same
paths through the kernels' plain versions on the host clock: a check of the
control flow, not a measurement of the card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import models as M
from .bench import LRS3, time_calls
from .models.convtasnet import fused_inference_forward
from .ops import kernels
from .ops.kernels.attention import k4_launches
from .ops.kernels.convtasnet_block import (
    convtasnet_separator_reference,
    fused_convtasnet_separator,
    fused_tcn_separator,
    pack_convtasnet_tcn_params,
    tcn_separator_reference,
)
from .ops.kernels.lstm import fused_bilstm, resident_bilstm
from .serve import Server
from .utils.profiling import count_params, estimate_cost

WSJ0_TASNET = dict(enc_dim=64, bn_dim=64, hidden_dim=128, win=16, layer=6, num_spk=2, block_size=100)
TDANET_LRS2 = dict(out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=5, enc_kernel_size=4,
                   num_sources=2)

# (name, model constructor, sample rate, batch, path): scripts/bench_all.py:26-44, then
# scripts/bench_kernel_only.py
CASES = [
    ("ConvTasNet (lrs3) fused", lambda: M.ConvTasNet(**LRS3), 16000, 8, "fused"),
    ("ConvTasNet (lrs3)", lambda: M.ConvTasNet(**LRS3), 16000, 8, "kernels"),
    ("TasNet-DPRNN (wsj0)", lambda: M.TasNet(**WSJ0_TASNET, module="DPRNN", sample_rate=8000), 8000, 8, "kernels"),
    ("TasNet-DPTNet (wsj0)", lambda: M.TasNet(**WSJ0_TASNET, module="DPTNet", sample_rate=8000), 8000, 8,
     "kernels"),
    ("Sepformer (base)", lambda: M.Sepformer(sample_rate=16000), 16000, 2, "kernels"),
    ("TDANet (lrs2) fast-analytic", lambda: M.TDANet(**TDANET_LRS2, sample_rate=16000), 16000, 4, "fast_tdanet"),
    ("TDANet (lrs2)", lambda: M.TDANet(**TDANET_LRS2, sample_rate=16000), 16000, 4, "kernels"),
    ("AFRCNN (lrs2)", lambda: M.AFRCNN(out_channels=512, in_channels=512, num_blocks=16, upsampling_depth=5,
                                       enc_kernel_size=1, num_sources=2, sample_rate=16000), 16000, 4, "kernels"),
    ("Sandglasset (defaults)", lambda: M.Sandglasset(sample_rate=8000), 8000, 8, "kernels"),
    ("DPRNNTasNet (legacy)", lambda: M.DPRNNTasNet(sample_rate=8000), 8000, 8, "kernels"),
    ("BSRNN (wsj0)", lambda: M.BSRNN(win=256, stride=64, feature_dim=128, num_spks=2, num_repeat=8,
                                     sample_rate=8000), 8000, 8, "kernels"),
    ("K2 alone (ConvTasNet lrs3 TCN chain)", lambda: M.ConvTasNet(**LRS3), 16000, 8, "k2"),
]

SECONDS = 2.0
ITERS = 50
K2_FRAMES = 8008  # scripts/bench_kernel_only.py's T' at 2 s (scaled with --seconds)
PEAK_FLOPS = 989e12  # H100 SXM bf16 dense tensor-core peak, FLOP/s
COUNTERS = {"K1": fused_convtasnet_separator, "K2": fused_tcn_separator, "K4": k4_launches,
            "K5": fused_bilstm, "K6": resident_bilstm}


def _k2_path(model, batch: int, frames: int, dev: torch.device):
    """(call, plain call, audio-seconds a call) of "K2 alone": the model's
    packed chain on seeded bf16 [batch, frames, 128]; a frame is a hop of
    L/2 samples."""
    *w, dils = pack_convtasnet_tcn_params(model.state_dict(), model.R, model.X, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(batch, frames, 128)).astype(np.float32))
    x = x.to(dev, torch.bfloat16)
    return (lambda: fused_tcn_separator(x, *w, dils), lambda: tcn_separator_reference(x, *w, dils),
            batch * frames * (model.L // 2) / model.sample_rate)


def bench_one(name: str, model, sr: int, batch: int, path: str, device="cuda", iters: int = ITERS,
              seconds: float = SECONDS) -> dict:
    """One row: ``model`` (f32, seeded) at B=batch x seconds through
    ``path``; returns ms a call, audio-sec/s, parameters, FLOPs a call,
    GFLOP per audio-second, the share of the bf16 peak and the kernel
    launches a call."""
    dev = torch.device(device)
    # no parameter needs a gradient here, so the FLOP count can run under no_grad: FlopCounterMode's module
    # tracker hooks the gradients of module inputs, and a view of a parameter that needs one, made under
    # no_grad, has none to hook
    model = model.to(dev).eval().requires_grad_(False)
    T = int(seconds * sr)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(batch, T)).astype(np.float32)).to(dev)
    if path == "k2":
        call, plain, audio_s = _k2_path(model, batch, int(K2_FRAMES * seconds / SECONDS), dev)
    else:
        server = Server(model, use_bf16=True, device=dev, dispatch=path)
        audio_s = batch * seconds

        def call():
            return server.forward(x)

        def plain():
            if path == "fused":
                with torch.no_grad():
                    return fused_inference_forward(server.model, x, packed=server.packed,
                                                   separator=convtasnet_separator_reference)
            return server.forward(x)

    for c in COUNTERS.values():
        c.launches = 0
    with torch.no_grad():
        dt = time_calls(call, dev, iters)
    launches = {k: c.launches / (iters + 1) for k, c in COUNTERS.items()}
    with kernels.plain_versions():
        flops = estimate_cost(plain)["flops"]
    ms = dt / iters * 1e3
    return {"name": name, "path": path, "batch": batch, "params": count_params(model), "ms": ms,
            "audio_sec_per_s": audio_s * iters / dt, "flops": flops, "gflop_per_audio_sec": flops / audio_s / 1e9,
            "peak_share": flops / (ms / 1e3) / PEAK_FLOPS, "launches": launches}


def row_line(r: dict) -> str:
    launched = ", ".join(f"{k} {v:g}" for k, v in r["launches"].items() if v)
    return (f"{r['name']} [{r['path']}]: {r['ms']:.4f} ms a call, {r['audio_sec_per_s']:.2f} audio-sec/s, "
            f"{r['gflop_per_audio_sec']:.3f} GFLOP/audio-sec, {100 * r['peak_share']:.4f}% of the bf16 peak "
            f"(params {r['params'] / 1e6:.2f}M; launches a call: {launched or 'none'})")


def table(rows, device: str, seconds: float = SECONDS) -> str:
    lines = [f"Inference, bf16, {seconds:g} s clips, on {device}", "",
             "| model [path] | params | batch | ms a call | audio-sec/s | GFLOP/audio-sec | % of 989 TFLOP/s |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        if "failed" in r:
            lines.append(f"| {r['name']} | FAILED | | | | | |")
            continue
        lines.append(f"| {r['name']} [{r['path']}] | {r['params'] / 1e6:.2f}M | {r['batch']} | {r['ms']:.4f} "
                     f"| {r['audio_sec_per_s']:.2f} | {r['gflop_per_audio_sec']:.3f} | "
                     f"{100 * r['peak_share']:.4f} |")
    return "\n".join(lines)


def device_name(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the plain versions on the CPU")
    return torch.cuda.get_device_name(dev)


def main(argv=None) -> list:
    """Every case (or those ``--only`` selects); returns the rows.  Raises
    SystemExit(1) after the table when a case failed."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=None, help="substring filter on case names")
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("--out", default=None, help="write the markdown table here")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (the plain versions)")
    parser.add_argument("--batch", type=int, default=None, help="every case's batch (default: its own)")
    parser.add_argument("--seconds", type=float, default=SECONDS)
    args = parser.parse_args(argv)
    if args.only and args.out:
        parser.error("--only runs a subset; a table written from it would drop the other rows")
    dev = torch.device(args.device)
    card = device_name(dev)
    rows = []
    for name, ctor, sr, batch, path in CASES:
        if args.only and args.only.lower() not in name.lower():
            continue
        try:
            torch.manual_seed(0)
            r = bench_one(name, ctor(), sr, args.batch or batch, path, dev, args.iters, args.seconds)
        except Exception as e:  # the sweep goes on, as the JAX script's does; the exit code says so
            print(f"{name}: FAILED ({type(e).__name__}: {str(e)[:200]})", flush=True)
            rows.append({"name": name, "path": path, "failed": f"{type(e).__name__}: {e}"})
            continue
        finally:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        print(row_line(r), flush=True)
        rows.append(r)
    text = table(rows, card, args.seconds)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if any("failed" in r for r in rows):
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
