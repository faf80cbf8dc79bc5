"""The top operations of one model's served forward (counterpart of
``scripts/profile_trace_ops.py``), under ``torch.profiler``.

    python -m audio_only_speech_separation_tpu_torch.profile_trace_ops sandglasset [--iters 10] [--top 30] [--seconds 2]
    python -m audio_only_speech_separation_tpu_torch.profile_trace_ops dprnn --device cpu --batch 1 --seconds 0.1 --iters 1

The 9 cases of ``scripts/profile_trace_ops.py:32-42`` at their widths,
rates and batches, served through ``serve.Server``'s dispatch with bf16
(on the card: "fused" for ConvTasNet, "fast_tdanet" for TDANet, "kernels"
for the rest).  After ``--iters`` warm-up calls and ``--iters`` timed
ones (host clock, the device synchronised), ``--iters`` calls run under
the profiler (CPU and CUDA activity); then the device's busy time (the
sum of its operations' self device times, ``utils/profiling.py::
device_events``) beside the wall times with and without the profiler, and
the top operations by self device time, with their calls.  The sum counts
operations that overlap twice, so it gives no idle share: the traced idle
share is the benchmark's ``device.idle_share.serve`` (``port_bench``).
``--device cpu`` profiles the host's operations by self CPU time: a check
of the control flow, not a measurement of the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .bench_all import CASES as CASES_ALL
from .bench_all import device_name
from .serve import Server
from .utils.profiling import device_events

# name -> (model constructor, sample rate, batch): scripts/profile_trace_ops.py:32-42, the configs and
# batches of bench_all's rows
_ROWS = {name: (ctor, sr, batch) for name, ctor, sr, batch, _ in CASES_ALL}
CASES = {"convtasnet": _ROWS["ConvTasNet (lrs3)"], "dprnn": _ROWS["TasNet-DPRNN (wsj0)"],
         "dptnet": _ROWS["TasNet-DPTNet (wsj0)"], "sepformer": _ROWS["Sepformer (base)"],
         "tdanet": _ROWS["TDANet (lrs2)"], "afrcnn": _ROWS["AFRCNN (lrs2)"],
         "sandglasset": _ROWS["Sandglasset (defaults)"], "dprnn_old": _ROWS["DPRNNTasNet (legacy)"],
         "bsrnn": _ROWS["BSRNN (wsj0)"]}


def profile_case(case: str, device="cuda", iters: int = 10, top: int = 30, seconds: float = 2.0,
                 batch=None) -> dict:
    """Profile ``iters`` served calls of ``case``; prints the table and
    returns {"dispatch", "ops": [(name, ms a call, calls a call)], "busy"
    (the device operations' self ms a call, None on the CPU), "wall" (ms a
    call under the profiler), "call" (ms a call without it)}."""
    from torch.profiler import ProfilerActivity, profile

    ctor, sr, default_batch = CASES[case]
    dev = torch.device(device)
    card = device_name(dev)
    torch.manual_seed(0)
    server = Server(ctor().to(dev).eval(), use_bf16=True, device=dev)
    B = batch or default_batch
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(B, int(seconds * sr))).astype(np.float32)).to(dev)
    cuda = dev.type == "cuda"

    def calls() -> float:
        """ms a call of ``iters`` calls, host clock, the device synchronised."""
        t0 = time.perf_counter()
        for _ in range(iters):
            server.forward(x)
        if cuda:
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3 / iters

    calls()  # warm-up, then the unprofiled time
    call_ms = calls()
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        wall = calls()  # the profiled window, the profiler's start and stop left out
    if cuda:
        events = device_events(prof)
        ops = sorted(((k, ms / iters, n / iters) for k, (ms, n) in events.items()), key=lambda r: -r[1])
        busy, clock = sum(ms for _, ms, _ in ops), "self device"
    else:
        ops = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters, e.count / iters) for e in prof.key_averages()),
                     key=lambda r: -r[1])
        busy, clock = None, "self CPU"
    print(f"{case} [{server.dispatch}] B={B} x {seconds:g} s x {sr // 1000} kHz, {iters} calls, on {card}")
    if cuda:
        print(f"device work {busy:.4f} ms a call (the operations' self times summed); {wall:.4f} ms a call with "
              f"the profiler on, {call_ms:.4f} without it (host clock)")
    else:
        print(f"{wall:.4f} ms a call with the profiler on, {call_ms:.4f} without it (host clock); device work: "
              f"not measured (no device)")
    print(f"{'ms a call':>12} {'calls':>8}  operation ({clock} time)")
    for name, ms, n in ops[:top]:
        print(f"{ms:12.4f} {n:8g}  {name[:110]}")
    return {"dispatch": server.dispatch, "ops": ops, "busy": busy, "wall": wall, "call": call_ms}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model", choices=sorted(CASES))
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--batch", type=int, default=None, help="in place of the case's batch")
    parser.add_argument("--device", default="cuda", help="cuda (the card) or cpu (the host's operations)")
    args = parser.parse_args(argv)
    return profile_case(args.model, args.device, args.iters, args.top, args.seconds, args.batch)


if __name__ == "__main__":
    main()
