#!/usr/bin/env python3
"""The port's elementwise probe (K7, ``ops/kernels/micro_vpu.py``) beside
the launch plans and options it was chosen over, on one NVIDIA GPU.

    python3 scripts/profile_port_micro_vpu.py [--rounds 3]

Run from the root of a checkout.  Builds ``csrc/micro_vpu.cu`` alone into
throwaway libraries under ``build/micro_vpu_profile/``, one for each
variant, all ``nvcc`` processes started together: the library's own
settings ("default"); every launch plan (threads a block x 32-bit words a
thread, ``-DMICRO_VPU_THREADS``/``-DMICRO_VPU_WORDS``, the same plan in all
four cases); without programmatic dependent launch (``-DMICRO_VPU_PDL=0``);
and with a chain of 0 steps (``-DMICRO_VPU_REPS=0``: the call without its
arithmetic, so launch, loads, stores and, with stats, the grid barrier).
For each of the script's four cases (f32 and bf16, with and without stats,
at [2048, 512]) each variant is first checked, the 64-step ones against the
plain version (bf16 bit for bit, f32 within 1e-5 of the output's magnitude,
the sum of squares within 1e-5), the 0-step one for returning its input,
then timed ``--rounds`` times (200 calls in one CUDA graph,
``micro_vpu.graph_us``), in turns over the variants so that the card's
drift falls on all of them alike.  A plan whose grid is not co-resident
with stats is outside the kernel and is reported so.  Prints the card's
name and power limit, each variant's times in µs a call with their median
and share of the bound (``chip_smoke.py::micro_vpu_bounds``), and the split of the
default's time into the fixed cost (the 0-step build) and a cost a step.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

PLANS = ((128, 2), (128, 4), (256, 2), (256, 4), (256, 8), (512, 2))


def variants() -> dict:
    """{label: the -D flags of its build}."""
    out = {"default": []}
    out.update({f"plan {t}x{w}": [f"-DMICRO_VPU_THREADS={t}", f"-DMICRO_VPU_WORDS={w}"] for t, w in PLANS})
    out["no pdl"] = ["-DMICRO_VPU_PDL=0"]
    out["0 steps"] = ["-DMICRO_VPU_REPS=0"]
    return out


def build_all(root: str) -> dict:
    """Build every variant of ``csrc/micro_vpu.cu`` at once; {label: library}."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import _build

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    src = str(_build._CSRC / "micro_vpu.cu")
    jobs = {}
    for i, (label, defines) in enumerate(variants().items()):
        path = os.path.join(root, f"variant{i}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-shared", "-o", path, src]
        jobs[label] = (path, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (path, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs[label] = _build.bind_micro_vpu(ctypes.CDLL(path))
    return libs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_port_micro_vpu: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from audio_only_speech_separation_tpu_torch.ops.kernels import micro_vpu as k7

    card = cs.card_identity()
    print(card)
    libs = build_all(os.path.join(os.getcwd(), "build", "micro_vpu_profile"))
    bounds = cs.micro_vpu_bounds()
    for dt in (torch.float32, torch.bfloat16):
        for ws in (False, True):
            x = k7.bench_input(dt)
            want, want_total = k7.micro_vpu_reference(x, ws, return_stats=True)
            runnable = []
            for label, lib in libs.items():
                if ws and label == "no pdl":
                    continue  # a stats call is a cooperative launch, never a dependent one
                try:
                    got, total = k7._launch(lib, x, ws, k7.A, k7.B)
                except ValueError as e:
                    print(f"  {dt} stats={ws} {label}: {e}")
                    continue
                torch.cuda.synchronize()
                if label == "0 steps":
                    ok = torch.equal(got, x) and float(total) == 0.0 if ws else torch.equal(got, x)
                else:
                    err = float((got.float() - want.float()).abs().max())
                    limit = 0.0 if dt == torch.bfloat16 else 1e-5 * float(want.float().abs().max())
                    rel = abs(float(total) - float(want_total)) / float(want_total) if ws else 0.0
                    ok = err <= limit and rel <= 1e-5
                if not ok:
                    raise AssertionError(f"K7 {dt} stats={ws} {label}: differs from its plain version")
                runnable.append(label)
            times = {label: [] for label in runnable}
            for _ in range(args.rounds):
                for label in runnable:
                    times[label].append(k7.graph_us(lambda lib=libs[label]: k7._launch(lib, x, ws, k7.A, k7.B)))
            bound_us = bounds[dt, ws][0] * 1e3
            print(f"{dt} stats={ws}: bound {bound_us:.4f} us ({bounds[dt, ws][1]}); {card}")
            for label, ts in times.items():
                med = statistics.median(ts)
                print(f"  {label}: " + ", ".join(f"{t:.4f}" for t in ts)
                      + f" us; median {med:.4f} us, {bound_us / med:.3f} of the bound")
            fixed = statistics.median(times["0 steps"])
            step_ns = (statistics.median(times["default"]) - fixed) / k7.REPS * 1e3
            print(f"  default: fixed cost {fixed:.4f} us a call, {step_ns:.2f} ns a step")


if __name__ == "__main__":
    main()
