"""Short-sequence self-attention (K4; counterpart of
``audio_only_speech_separation_tpu/ops/pallas/attention.py``) in two operand
layouts: ``fused_attention_bdt`` on [BH, dh, T] (the JAX package's layout)
and ``fused_attention_packed``, which reads q, k and v straight from the
packed in-projection [B, T, 3E] and writes [B, T, E] in token order.  Each
CUDA wrapper has its plain version and its launch counter (``k4_launches``
counts both); ``attention_kernel_ok`` is their envelope.

``softmax(q^T k / sqrt(dh)) v`` per head, no mask: f32 logits and softmax,
the probabilities rounded to v's dtype, f32-accumulated products, output in
v's dtype.  The kernel (``csrc/attention.cu``, one body, the layout a
template parameter) takes bf16 with dh % 8 == 0, 8 <= dh <= 256 and any
T >= 1.  It works in the FlashAttention-2 manner on mma.sync: one warp per
16 queries, the logits and the output in registers, an online softmax over
64-key steps.  So it rounds the probabilities before their normalisation,
where the plain versions round after it.

Dispatch (``ops/attention.py``) takes the kernel only where
``attention_kernel_ok`` holds; on a CUDA tensor outside it the wrappers
raise.  The backward recomputes through the plain version under autograd,
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


def attention_packed_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain version of ``fused_attention_packed``, same arguments and
    result: ``attention_bdt_reference`` on q, k and v permuted out of
    [B, T, 3E] into [B*h, dh, T], its output permuted back to a contiguous
    [B, T, E]."""
    B, T, E3 = qkv.shape
    dh = E3 // (3 * num_heads)
    x = qkv.reshape(B, T, 3, num_heads, dh)
    o = attention_bdt_reference(*(x[:, :, j].permute(0, 2, 3, 1).reshape(B * num_heads, dh, T)
                                  for j in range(3)))
    return o.reshape(B, num_heads, dh, T).permute(0, 3, 1, 2).reshape(B, T, E3 // 3).contiguous()


def _check_packed(qkv, num_heads):
    if qkv.ndim != 3 or num_heads < 1 or qkv.shape[2] % (3 * num_heads) or qkv.shape[1] < 1:
        raise ValueError(f"qkv must be [B, T >= 1, 3 * {num_heads} * dh]; got {tuple(qkv.shape)}")
    dh = qkv.shape[2] // (3 * num_heads)
    if not attention_kernel_ok(dh):
        raise ValueError(f"kernel takes dh % 8 == 0, 8 <= dh <= 256; got dh={dh}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")


def _launch_packed(qkv, num_heads):
    from ._build import check_launch, load_library

    B, T, E3 = qkv.shape
    _check("qkv", qkv, qkv.shape, torch.bfloat16, qkv.device)
    _check_aligned("qkv", qkv)
    out = qkv.new_empty(B, T, E3 // 3)
    lib = load_library()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = lib.attention_packed(qkv.data_ptr(), out.data_ptr(), B, num_heads, E3 // (3 * num_heads), T,
                                  stream)
    check_launch(lib, "attention_packed", rc)
    fused_attention_packed.launches += 1
    return out


class _AttentionPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return _launch_packed(qkv, num_heads)

    @staticmethod
    def backward(ctx, g):
        def plain(qkv):
            return attention_packed_reference(qkv, ctx.num_heads)

        return *grad_through_plain(plain, ctx.saved_tensors, ctx.needs_input_grad[:1], g), None


def fused_attention_packed(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """softmax(q^T k / sqrt(dh)) v per head of the packed in-projection
    ``qkv`` [B, T, 3E] (token t's q of head j at [b, t, j*dh : (j+1)*dh],
    its k at +E, its v at +2E; self-attention, no mask), as [B, T, E] with
    head j in columns j*dh : (j+1)*dh.

    ``qkv`` must be contiguous with dh inside ``attention_kernel_ok``, or
    the call raises.  A CUDA tensor launches the kernel (one launch, added
    to ``fused_attention_packed.launches``, under the span ``kernels.k4``);
    a CPU tensor runs ``attention_packed_reference``; any other raises.
    Differentiable."""
    _check_packed(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_packed_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    with span("kernels.k4"):
        return _AttentionPacked.apply(qkv, num_heads)


fused_attention_packed.launches = 0


class _K4Launches:
    """K4's launches through either entry, as one counter: ``launches`` is
    the sum of the two wrappers' counts, and setting it to 0 zeroes both."""

    @property
    def launches(self) -> int:
        return fused_attention_bdt.launches + fused_attention_packed.launches

    @launches.setter
    def launches(self, n: int) -> None:
        if n != 0:
            raise ValueError("K4's launch counter is only reset, to 0")
        fused_attention_bdt.launches = fused_attention_packed.launches = 0


k4_launches = _K4Launches()
