"""Multi-head attention in ``nn.MultiheadAttention``'s parameter layout
(counterpart of ``audio_only_speech_separation_tpu/ops/attention.py``), so
look2hear checkpoints load: ``in_proj_weight`` [3E, E], ``in_proj_bias``
[3E], ``out_proj.{weight, bias}``.  It never calls
``nn.MultiheadAttention.forward`` or ``scaled_dot_product_attention``.

Dispatch, per call:

- bf16 self-attention on a CUDA device (``kernels.kernel_input``), with no
  mask and no training dropout, and a head width the kernel takes
  (``attention_kernel_ok``: dh % 8 == 0, 8 <= dh <= 256): the kernel form.
  The q, k and v projections are written straight in the kernel's
  [B*h, dh, T] layout (library matmuls, f32-accumulated, rounded to bf16,
  as the JAX package leaves them to XLA), attention is the CUDA kernel K4
  (``ops/kernels/attention.py::fused_attention_bdt``, FlashAttention-2 on
  mma.sync, or its plain version inside ``ops.kernels.plain_versions()``),
  then the output projection.  Any T: the JAX package's TPU gate
  (``attention_eligible``) is dropped.
- anything else (f32, a CPU tensor, a mask, cross-attention, training
  dropout, a head width outside the envelope): the plain einsum form, f32
  logits and softmax.

The 4-D batched-axis form of the JAX module (``_mha_batched_axis1``,
Sandglasset's) is not ported yet (ROADMAP Queue 1).

Also the fixed sinusoidal positions (``sinusoidal_positions``,
``PositionalEncoding``) that Sepformer adds to each transformer stack's
input.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import kernels
from .kernels.attention import attention_bdt_reference, attention_kernel_ok, fused_attention_bdt


def mha_kernel_form(x, w_in, b_in, w_out, b_out, num_heads: int, attention=fused_attention_bdt):
    """Self-attention on x [B, T, E] around ``attention`` on [B*h, dh, T]:
    w_in [3E, E], b_in [3E] or None, w_out [E, E] (torch ``[out, in]``),
    b_out [E] or None.  Products accumulate in f32 and round to x's dtype."""
    B, T, E = x.shape
    dh = E // num_heads
    xt = x.transpose(1, 2)  # [B, E, T]
    qkv = []
    for j in range(3):
        y = torch.matmul(w_in[j * E:(j + 1) * E].to(x.dtype), xt)  # [B, E, T]
        if b_in is not None:
            y = y + b_in[j * E:(j + 1) * E].to(x.dtype)[:, None]
        qkv.append(y.reshape(B * num_heads, dh, T).contiguous())
    o = attention(*qkv).reshape(B, E, T)
    out = torch.matmul(o.transpose(1, 2), w_out.to(o.dtype).t())  # [B, T, E]
    return out + b_out.to(out.dtype) if b_out is not None else out


def mha_plain_form(query, key, value, w_in, b_in, w_out, b_out, num_heads: int,
                   mask=None, dropout: float = 0.0, training: bool = False):
    """The JAX module's einsum path: [B, Tq, E] queries against [B, Tk, E]
    keys and values; f32 logits and softmax, the weights cast to v's dtype;
    ``mask`` broadcastable to [B, h, Tq, Tk] (True keeps)."""
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
    if dropout > 0.0:
        attn = F.dropout(attn, dropout, training=training)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float()).to(v.dtype)
    out = torch.matmul(out.reshape(*query.shape[:2], E), w_out.to(out.dtype).t())
    return out + b_out.to(out.dtype) if b_out is not None else out


class MultiheadAttention(nn.Module):
    """Self- or cross-attention on [B, T, E] (see the module docstring for
    the dispatch).  ``dropout`` acts on the attention weights while
    training, as in ``nn.MultiheadAttention``."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True, dropout: float = 0.0,
                 device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim, device=device)) if bias else None
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None):
        if query.ndim != 3:
            raise NotImplementedError("only [B, T, E] inputs: the 4-D batched-axis form is still "
                                      "to port (ROADMAP Queue 1)")
        self_attention = (key is None or key is query) and (value is None or value is query)
        w = (self.in_proj_weight, self.in_proj_bias, self.out_proj.weight, self.out_proj.bias)
        dropping = self.training and self.dropout > 0.0
        if (self_attention and mask is None and not dropping and kernels.kernel_input(query)
                and attention_kernel_ok(self.embed_dim // self.num_heads)):
            attention = kernels.pick(fused_attention_bdt, attention_bdt_reference)
            return mha_kernel_form(query, *w, self.num_heads, attention)
        key = query if key is None else key
        value = key if value is None else value
        return mha_plain_form(query, key, value, *w, self.num_heads, mask,
                              self.dropout, self.training)


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


class PositionalEncoding(nn.Module):
    """Adds fixed sinusoidal positions to [B, T, E], in x's dtype.  No
    parameters; each (T, dtype, device) table is built once and kept."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self._tables = {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        key = (x.shape[1], x.dtype, x.device)
        if key not in self._tables:
            self._tables[key] = sinusoidal_positions(x.shape[1], self.d_model, x.dtype, x.device)
        return x + self._tables[key][None]
