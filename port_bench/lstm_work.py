"""K5's and K6's work (``ops/kernels/lstm.py``, ``csrc/lstm.cu``), from
shapes alone, and the share of their roofline a trace shows, for
``metrics/k5_roofline.py`` and ``metrics/k6_roofline.py``; a kernel's
least time is ``bounds.least_time`` of its work.  The shapes of a
request's launches come from the reference's ``lstm_shapes``."""

from __future__ import annotations

from port_bench.bounds import least_time


def recurrence_work(T: int, D: int, B: int, H: int):
    """(bytes, FLOPs) of K5 on pre-projected gates xw [T, D, B, 4H] in bf16:
    xw read and the hidden states [T, D, B, H] written once, W_hh [D, H, 4H]
    read once; the recurrent product h @ W_hh of every step, 2 FLOPs a
    multiply-add (gates and cell updates not counted)."""
    return 2 * (T * D * B * 4 * H + T * D * B * H + D * H * 4 * H), 2 * T * D * B * H * 4 * H


def resident_work(T: int, B: int, Din: int, H: int, D: int):
    """(bytes, FLOPs) of K6 on x [B, T, Din] in bf16: x read and the hidden
    states [T, D, B, H] written once, W_ih [D, Din, 4H] and W_hh [D, H, 4H]
    read once; the input and recurrent products of every step, 2 FLOPs a
    multiply-add.  The f32 bias [D, 4H] is not counted: at the cell's shape
    it is 8 KiB beside 1.5 MiB of weights."""
    return 2 * (B * T * Din + T * D * B * H + D * (Din + H) * 4 * H), 2 * T * D * B * (Din + H) * 4 * H


def roofline(ctx, kernel: str, kind: str, work):
    """100 x the least time of every ``kind`` ("K5" or "K6") launch of the
    traced requests at their padded shapes (``lstm_shapes``, each through
    ``work``) over the device time of the operations named ``kernel`` in
    the trace; None where no such operation ran."""
    tr = ctx.trace
    spent = tr.device_seconds((kernel,)) if tr is not None else 0.0
    if spent <= 0:
        return None
    a = ctx.cell.cfg["model_args"]
    bucket = ctx.read["bucket"]
    least = 0.0
    for req in ctx.read["traced"]["requests"]:
        T = -(-max(req) // bucket) * bucket
        least += sum(least_time(*work(*s))[0] for s in ctx.cell.ref.lstm_shapes(a, len(req), T)[kind])
    return 100.0 * least / spent
