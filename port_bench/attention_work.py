"""K4's work (``ops/kernels/attention.py``, ``csrc/attention.cu``), from
shapes alone, for ``metrics/k4_roofline.py``; its least time is
``bounds.least_time`` of it."""

from __future__ import annotations


def attention_work(BH: int, dh: int, T: int):
    """(bytes, FLOPs) of self-attention on [BH, dh, T] in bf16: q, k and v
    read and o written once; the logits q^T k and the weighted sum p v,
    2 FLOPs a multiply-add each (softmax not counted)."""
    return 4 * BH * dh * T * 2, 4 * BH * T * T * dh
