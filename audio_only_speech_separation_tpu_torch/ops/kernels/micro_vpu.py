"""Elementwise probe (K7; counterpart of the JAX package's
``scripts/micro_vpu.py``): the CUDA wrapper ``micro_vpu``, its plain
version, its launch counter and ``bench``, the script's four cases timed on
the card.

The function, as the Pallas kernel ``make_kernel`` computes it on x [N, C]
(the script's N 2048, C 512) in f32 or bf16: 64 times

    x = x * a + b
    x = where(x >= 0, x, a * x)
    (with stats) acc += sum(f32(x) ** 2)

with a = 1.0009 and b = 0.999 rounded to x's dtype (1 and 1 in bf16),
then out = x + acc * 1e-30 in x's dtype.  It asks whether packed bf16
elementwise work runs at twice the f32 rate (HFMA2 on ``__nv_bfloat162``
against FFMA here), which decides whether a kernel should stay bf16
through its epilogues (``csrc/micro_vpu.cu``).

The kernel fuses x * a + b into one rounding, where the plain version (as
the JAX package) rounds the product and the sum apart; in bf16 a is 1, so
the product is exact and the two agree.  With stats the kernel sums the
squares per thread, per block and then the blocks' partials in a fixed
order, the plain version in torch's order: the totals differ in f32
rounding only.

    python -m audio_only_speech_separation_tpu_torch.ops.kernels.micro_vpu

prints the script's four lines (µs a call and Gop/s by the script's
operation count) on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .convtasnet_block import _check, _check_aligned

N, C = 2048, 512  # the script's array
REPS = 64  # the chain's length
A, B = 1.0009, 0.999


def ops_per_element(with_stats: bool) -> int:
    """The script's operation count an element (scripts/micro_vpu.py:63-64):
    a multiply-add (2) and the select (3) a step, 3 more with stats."""
    return REPS * (5 + (3 if with_stats else 0))


def micro_vpu_reference(x: torch.Tensor, with_stats: bool = False, return_stats: bool = False):
    """Plain version of ``micro_vpu``, same arguments and result: each op
    rounded to x's dtype, as the JAX package's kernel body."""
    dt = x.dtype
    a = torch.tensor(A, dtype=dt, device=x.device)
    b = torch.tensor(B, dtype=dt, device=x.device)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(REPS):
        x = x * a + b
        x = torch.where(x >= 0, x, a * x)
        if with_stats:
            xf = x.float()
            acc = acc + (xf * xf).sum()
    out = x + acc.to(dt) * torch.tensor(1e-30, dtype=dt, device=x.device)
    return (out, acc) if return_stats else out


def _launch(x, with_stats):
    from ._build import check_launch, load_library

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"micro_vpu takes float32 or bfloat16, got {x.dtype}")
    _check("x", x, x.shape, x.dtype, x.device)
    _check_aligned("x", x)
    n, bf16 = x.numel(), x.dtype == torch.bfloat16
    if n % (8 if bf16 else 4) or not 0 < n < 2**31:
        raise ValueError(f"micro_vpu takes a multiple of {8 if bf16 else 4} elements below 2**31, got {n}")
    lib = load_library()
    out = torch.empty_like(x)
    # with stats: the blocks' partials, then the sum of squares
    parts = torch.empty(lib.micro_vpu_partials(n, int(bf16)) + 1 if with_stats else 1,
                        dtype=torch.float32, device=x.device)
    total = parts[-1]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.micro_vpu(x.data_ptr(), out.data_ptr(), parts.data_ptr(), total.data_ptr(), n, int(bf16),
                           int(with_stats), A, B, stream)
    check_launch(lib, "micro_vpu", rc)
    micro_vpu.launches += lib.micro_vpu_launches(int(with_stats))
    return out, total


def micro_vpu(x: torch.Tensor, with_stats: bool = False, return_stats: bool = False):
    """The 64-step chain on a contiguous f32 or bf16 tensor, the result in
    x's dtype; with ``return_stats`` (and ``with_stats``) also the f32 sum of
    squares.

    A CUDA tensor launches the kernel (1 launch, 2 with stats, added to
    ``micro_vpu.launches``) or raises; a CPU tensor runs
    ``micro_vpu_reference``."""
    if x.device.type == "cpu":
        return micro_vpu_reference(x, with_stats, return_stats)
    if x.device.type != "cuda":
        raise ValueError(f"no micro_vpu kernel for device {x.device}")
    out, total = _launch(x, with_stats)
    return (out, total) if return_stats else out


micro_vpu.launches = 0


def bench_input(dtype: torch.dtype) -> torch.Tensor:
    """The script's input on the card: N x C standard normals from numpy's
    generator seeded 0, in ``dtype``."""
    x = np.random.default_rng(0).normal(size=(N, C))
    return torch.from_numpy(x.astype(np.float32)).to(device="cuda", dtype=dtype)


def bench(dtype: torch.dtype, with_stats: bool, iters: int = 200) -> dict:
    """One of the script's cases on the card, timed as the script times its
    jitted loop, with no host work between calls: ``iters`` calls captured
    in one CUDA graph (their launches counted once, at the capture), the
    graph replayed between two CUDA events after a warm-up call.  Prints
    the script's line and returns {"us": µs a call, "gops": Gop/s by the
    script's count}."""
    if not torch.cuda.is_available():
        raise RuntimeError("micro_vpu.bench: no CUDA device")
    x = bench_input(dtype)
    micro_vpu(x, with_stats)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            micro_vpu(x, with_stats)
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    us = start.elapsed_time(end) * 1e3 / iters
    gops = N * C * ops_per_element(with_stats) / (us * 1e-6) / 1e9
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    print(f"dtype={name:9s} stats={with_stats}  {us:8.1f} us/call  ~{gops:7.0f} Gop/s")
    return {"us": us, "gops": gops}


if __name__ == "__main__":
    for dt in (torch.float32, torch.bfloat16):
        for ws in (False, True):
            bench(dt, ws)
