"""Multi-head attention in ``nn.MultiheadAttention``'s parameter layout
(counterpart of ``audio_only_speech_separation_tpu/ops/attention.py``), so
look2hear checkpoints load: ``in_proj_weight`` [3E, E], ``in_proj_bias``
[3E], ``out_proj.{weight, bias}``.  It never calls
``nn.MultiheadAttention.forward`` or ``scaled_dot_product_attention``.

Dispatch, per call:

- bf16 self-attention on a CUDA device (``kernels.kernel_input``), with no
  mask and no training dropout, and a head width the kernel takes
  (``attention_kernel_ok``: dh % 8 == 0, 8 <= dh <= 256): the kernel form.
  On [B, T, E] it is three launches: one library product into the packed
  in-projection [B*T, 3E], the CUDA kernel K4 reading q, k and v straight
  from it and writing its output in token order
  (``ops/kernels/attention.py::fused_attention_packed``, FlashAttention-2 on
  mma.sync, or its plain version inside ``ops.kernels.plain_versions()``),
  and the output product.  Each product accumulates in f32 and adds its
  bias in f32 before its one rounding to bf16, as the layer's FFN
  ``nn.Linear``s do (the JAX package leaves the products to XLA and adds
  the biases after the rounding).  Any T: the JAX package's TPU gate
  (``attention_eligible``) is dropped.
- anything else (f32, a CPU tensor, a mask, cross-attention, training
  dropout, a head width outside the envelope): the plain einsum form, f32
  logits and softmax.

A 4-D input [B, T, K, E] attends over axis 1 with K as a second batch
axis (the JAX module's ``_mha_batched_axis1``, Sandglasset's identity-pool
blocks), self-attention only, with the same dispatch.  Its kernel form
writes q, k and v straight into K4's [B*K*h, dh, T] layout and the output
projection straight back to [B, T, K, E], each a batched product over K
whose operands are strided views of the block tensor, so no transposed
copy of it is made, around K4's [B*h, dh, T] entry ``fused_attention_bdt``;
its plain form is the JAX einsum path.

Also the fixed sinusoidal positions (``sinusoidal_positions``,
``PositionalEncoding``) that Sepformer adds to each transformer stack's
input.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import kernels
from .dropout import Dropout
from .kernels.attention import (
    attention_bdt_reference,
    attention_kernel_ok,
    attention_packed_reference,
    fused_attention_bdt,
    fused_attention_packed,
)


def _linear(x2d, w, b):
    """x2d @ w^T (+ b): one library product, the bias in its f32 epilogue."""
    w = w.to(x2d.dtype).t()
    return torch.mm(x2d, w) if b is None else torch.addmm(b.to(x2d.dtype), x2d, w)


def mha_kernel_form(x, w_in, b_in, w_out, b_out, num_heads: int, attention=fused_attention_packed):
    """Self-attention on x [B, T, E] around ``attention`` (qkv [B, T, 3E],
    num_heads) -> [B, T, E]: w_in [3E, E], b_in [3E] or None, w_out [E, E]
    (torch ``[out, in]``), b_out [E] or None.  Products accumulate in f32,
    add their bias and round once to x's dtype."""
    B, T, E = x.shape
    qkv = _linear(x.reshape(B * T, E), w_in, b_in).view(B, T, 3 * E)
    o = attention(qkv, num_heads).view(B * T, E)
    return _linear(o, w_out, b_out).view(B, T, E)


def _bmm_into(out: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """a @ b (batched) written into the view ``out``: by the product itself
    where no gradient is recorded, else through a copy autograd can follow
    (``out=`` records none)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        out.copy_(torch.bmm(a, b))
    else:
        torch.bmm(a, b, out=out)


def mha_batched_axis1_kernel_form(x, w_in, b_in, w_out, b_out, num_heads: int,
                                  attention=fused_attention_bdt):
    """Self-attention over axis 1 of x [B, T, K, E] around ``attention`` on
    [B*K*h, dh, T]; weights as ``mha_kernel_form``'s.

    For each b, q[b] = W_q x[b]^T is one product batched over K whose
    right operand x[b, :, k, :]^T is a view (batch stride E, leading
    dimension K*E), written into [K, E, T]; the output [b, :, k, :] =
    o[b, k]^T W_out^T is written through a view of [T, K, E] the same way.
    Products accumulate in f32 and round to x's dtype; the biases are added
    after the rounding, as the JAX package does."""
    B, T, K, E = x.shape
    dh = E // num_heads
    qkv = []
    for j in range(3):
        w = w_in[j * E:(j + 1) * E].to(x.dtype).expand(K, E, E)
        y = x.new_empty(B, K, E, T)
        for b in range(B):
            _bmm_into(y[b], w, x[b].permute(1, 2, 0))  # [K, E, T]
        if b_in is not None:
            y.add_(b_in[j * E:(j + 1) * E].to(x.dtype)[:, None])
        qkv.append(y.view(B * K * num_heads, dh, T))
    o = attention(*qkv).view(B, K, E, T)
    wo = w_out.to(o.dtype).t().expand(K, E, E)
    out = o.new_empty(B, T, K, E)
    for b in range(B):
        _bmm_into(out[b].transpose(0, 1), o[b].transpose(1, 2), wo)  # into a [K, T, E] view
    return out.add_(b_out.to(out.dtype)) if b_out is not None else out


def mha_batched_axis1_plain_form(x, w_in, b_in, w_out, b_out, num_heads: int, drop=None):
    """The JAX package's einsum path of the 4-D form: per-head q, k, v on
    [B, T, K, h, dh] in x's dtype, f32 logits and softmax over axis 1, the
    weights cast to v's dtype, then ``drop`` on them; the output projection
    f32-accumulated."""
    B, T, K, E = x.shape
    dh = E // num_heads
    bs = (None, None, None) if b_in is None else b_in.split(E)

    def proj(j):
        y = torch.matmul(x, w_in[j * E:(j + 1) * E].to(x.dtype).t())
        y = y if bs[j] is None else y + bs[j].to(y.dtype)
        return y.reshape(B, T, K, num_heads, dh)

    q, k, v = proj(0), proj(1), proj(2)
    logits = torch.einsum("bqkhd,btkhd->bkhqt", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    if drop is not None:
        attn = drop(attn)
    out = torch.einsum("bkhqt,btkhd->bqkhd", attn.float(), v.float()).to(v.dtype)
    out = torch.matmul(out.reshape(B, T, K, E), w_out.to(out.dtype).t())
    return out + b_out.to(out.dtype) if b_out is not None else out


def mha_plain_form(query, key, value, w_in, b_in, w_out, b_out, num_heads: int,
                   mask=None, drop=None):
    """The JAX module's einsum path: [B, Tq, E] queries against [B, Tk, E]
    keys and values; f32 logits and softmax, the weights cast to v's dtype,
    then ``drop`` (a dropout module, or None) on them; ``mask``
    broadcastable to [B, h, Tq, Tk] (True keeps)."""
    E = query.shape[-1]
    dh = E // num_heads
    bs = (None, None, None) if b_in is None else b_in.split(E)

    def proj(x, j):
        y = torch.matmul(x, w_in[j * E:(j + 1) * E].to(x.dtype).t())
        y = y if bs[j] is None else y + bs[j].to(y.dtype)
        return y.reshape(*x.shape[:2], num_heads, dh)

    q, k, v = proj(query, 0), proj(key, 1), proj(value, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
    attn = torch.softmax(logits, dim=-1).to(v.dtype)
    if drop is not None:
        attn = drop(attn)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).to(v.dtype)
    out = torch.matmul(out.reshape(*query.shape[:2], E), w_out.to(out.dtype).t())
    return out + b_out.to(out.dtype) if b_out is not None else out


class MultiheadAttention(nn.Module):
    """Self- or cross-attention on [B, T, E], or self-attention over axis
    1 of [B, T, K, E] (see the module docstring for the dispatch).  ``dropout`` acts on the attention weights while
    training, as in ``nn.MultiheadAttention``, with the masks from its own
    generator (``ops/dropout.py``)."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, dropout: float = 0.0,
                 device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.attn_drop = Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device)) if bias else None
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        self_attention = (key is None or key is query) and (value is None or value is query)
        w = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight, self.out_proj.bias)
        dropping = self.training and self.attn_drop.rate > 0.0
        kernel_form = (self_attention and mask is None and not dropping and kernels.kernel_input(query)
                       and attention_kernel_ok(self.embed_dim // self.num_heads))
        if query.ndim == 4:
            if not self_attention or mask is not None:
                raise ValueError("a 4-D input [B, T, K, E] takes self-attention without a mask")
            if kernel_form:
                return mha_batched_axis1_kernel_form(
                    query, *w, self.num_heads, kernels.pick(fused_attention_bdt, attention_bdt_reference))
            return mha_batched_axis1_plain_form(query, *w, self.num_heads,
                                                self.attn_drop if dropping else None)
        if kernel_form:
            return mha_kernel_form(query, *w, self.num_heads,
                                   kernels.pick(fused_attention_packed, attention_packed_reference))
        key = query if key is None else key
        value = key if value is None else value
        return mha_plain_form(query, key, value, *w, self.num_heads, mask,
                              self.attn_drop if dropping else None)


def sinusoidal_positions(max_len: int, d_model: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sinusoidal table [max_len, d_model] (reference sepformer.py:53-80),
    built in float64 and rounded once to ``dtype``; at an odd ``d_model``
    the cosine columns take the first d_model // 2 frequencies."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: (d_model + 1) // 2][: table[:, 1::2].shape[1]])
    return torch.from_numpy(table).to(device=device, dtype=dtype)


@lru_cache(maxsize=64)
def positions_table(max_len: int, d_model: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``sinusoidal_positions`` built once a (length, width, dtype, device)
    and kept: a copy from host memory inside a forward would wait for the
    device's queue."""
    return sinusoidal_positions(max_len, d_model, dtype, device)


class PositionalEncoding(nn.Module):
    """Adds fixed sinusoidal positions to [B, T, E], in x's dtype.  No
    parameters."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + positions_table(x.shape[1], self.d_model, x.dtype, x.device)[None]
