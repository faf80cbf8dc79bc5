"""Short-sequence self-attention on [BH, dh, T] (K4; counterpart of
``audio_only_speech_separation_tpu/ops/pallas/attention.py``): the CUDA
wrapper ``fused_attention_bdt``, its plain version, its launch counter and
its envelope ``attention_kernel_ok``.

``softmax(q^T k / sqrt(dh)) v`` per head, no mask: f32 logits and softmax,
the probabilities rounded to v's dtype, f32-accumulated products, output in
v's dtype.  The kernel (``csrc/attention.cu``) takes bf16 with dh % 8 == 0,
8 <= dh <= 256 and any T >= 1.  It works in the FlashAttention-2 manner on
mma.sync: one warp per 16 queries, the logits and the output in registers,
an online softmax over 64-key steps.  So it rounds the probabilities before
their normalisation, where the plain version rounds after it.

Dispatch (``ops/attention.py``) takes the kernel only where
``attention_kernel_ok`` holds; on a CUDA tensor outside it the wrapper
raises.  The backward recomputes through the plain version under autograd,
as the JAX package's custom VJP does through its einsum form; no backward
kernel exists there to port.
"""

from __future__ import annotations

import math

import torch

from ...utils.profiling import span
from . import grad_through_plain
from .convtasnet_block import _check, _check_aligned


def attention_bdt_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fused_attention_bdt``, same arguments and result
    (the JAX package's ``_einsum_attention_bdt``)."""
    scale = 1.0 / math.sqrt(q.shape[1])
    logits = torch.matmul(q.float().transpose(1, 2), k.float())  # [BH, Tq, Tk]
    attn = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.matmul(v.float(), attn.float().transpose(1, 2)).to(v.dtype)  # [BH, dh, Tq]


def attention_kernel_ok(dh: int) -> bool:
    """Whether the kernel takes heads of width ``dh`` (any T >= 1)."""
    return dh % 8 == 0 and 8 <= dh <= 256


def _launch(q, k, v):
    from ._build import check_launch, load_library

    dev = q.device
    BH, dh, T = q.shape
    if not attention_kernel_ok(dh) or T < 1:
        raise ValueError(f"kernel takes dh % 8 == 0, 8 <= dh <= 256, T >= 1; got dh={dh}, T={T}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.shape, torch.bfloat16, dev)
        _check_aligned(name, t)
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.attention_bdt(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               BH, dh, T, stream)
    check_launch(lib, "attention_bdt", rc)
    fused_attention_bdt.launches += 1
    return out


class _AttentionBDT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        return grad_through_plain(attention_bdt_reference, ctx.saved_tensors,
                                  ctx.needs_input_grad, g)


def fused_attention_bdt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q^T k / sqrt(dh)) v on [BH, dh, T] (self-attention, no mask).

    A CUDA tensor launches the kernel (one launch, added to
    ``fused_attention_bdt.launches``, under the span ``kernels.k4``) or
    raises; a CPU tensor runs ``attention_bdt_reference``.  Differentiable."""
    if q.device.type == "cpu":
        return attention_bdt_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    with span("kernels.k4"):
        return _AttentionBDT.apply(q, k, v)


fused_attention_bdt.launches = 0
