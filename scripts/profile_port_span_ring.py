#!/usr/bin/env python3
"""The host's cost of a span of the port (``utils/profiling.py::span``, the
always-on span ring) against the no-op that ``span`` returned before the
ring (one flag read, then a shared ``contextlib.nullcontext``), with no
profiler running.

    python3 scripts/profile_port_span_ring.py [--rounds 200000] [--reps 7]

Run from the root of a checkout.  Each round enters three spans nested in
one another with an empty body, as the port nests ``serve.call`` ⊃
``serve.forward`` ⊃ ``forward.separator``; each form is timed ``--reps``
times over ``--rounds`` rounds, in turns.  Prints the host's CPU model, the
card's name and power limit where there is a card, and for each form the
least and the median ns a span over the repetitions, then the ring's cost
over the no-op's (least against least).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import platform
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import profiler as _autograd_profiler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from audio_only_speech_separation_tpu_torch.utils import profiling  # noqa: E402

_NO_SPAN = contextlib.nullcontext()


def no_op_span(name: str):
    """``span`` as it was before the ring."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def ns_a_span(make, rounds: int) -> float:
    t = time.perf_counter_ns()
    for _ in range(rounds):
        with make("serve.call"):
            with make("serve.forward"):
                with make("forward.separator"):
                    pass
    return (time.perf_counter_ns() - t) / (3 * rounds)


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        named = [ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")]
    return f"{named[0] if named else platform.machine()}, {os.cpu_count()} CPUs"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=200000)
    p.add_argument("--reps", type=int, default=7)
    args = p.parse_args(argv)
    print(f"host CPU: {cpu_model()}")
    if torch.cuda.is_available():
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        print(f"card: {card}")
    forms = {"no-op (before the ring)": no_op_span, "ring": profiling.span}
    got = {k: [] for k in forms}
    for make in forms.values():  # one warm-up pass each
        ns_a_span(make, args.rounds // 10)
    for _ in range(args.reps):
        for k, make in forms.items():
            got[k].append(ns_a_span(make, args.rounds))
    for k, v in got.items():
        print(f"{k}: least {min(v):.1f} ns a span, median {statistics.median(v):.1f} ns")
    print(f"ring over no-op: {min(got['ring']) - min(got['no-op (before the ring)']):.1f} ns a span")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
