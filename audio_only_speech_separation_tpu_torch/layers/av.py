"""Audio-visual, conformer and pyramid layers (counterpart of
``audio_only_speech_separation_tpu/layers/av.py``; reference
look2hear/layers/cnnlayers.py:163-805, rnnlayers.py:228-543, 793-927):
the video branch's conv block, audio/video fusion, the bottom-up pyramids,
the conformer pieces and the dual-path block with a Linear inter-chunk
path.

``RelativeMultiHeadAttention`` computes its own scores with the relative
position term (einsums, the shift trick), as the JAX module does: K4 has
no positional term.  ``DPRNNLinear``'s intra-chunk BiLSTM is
``ops/rnn.py``'s (K5/K6 on the card in bf16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import PReLU
from ..ops.attention import positions_table
from ..ops.conv import Conv1d, PointwiseConv
from ..ops.norms import BatchNorm1d, GlobalLayerNorm
from ..ops.resample import interpolate_nearest
from ..ops.rnn import BiLSTM
from .blocks import ConvNorm, ConvNormAct, _from_rows, _rows


class Video1DConv(nn.Module):
    """Video-branch depthwise conv block on [B, N, T] (reference
    cnnlayers.py:163-229): past the first block ReLU and BatchNorm (its
    running statistics in eval mode, the batch's in training mode), the
    dilated depthwise conv, then (skip, residual) through ``sconv`` or one
    output through ``bconv``."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int, dilation: int = 1, residual: bool = True,
                 skip_con: bool = True, first_block: bool = True, device=None):
        super().__init__()
        self.residual, self.skip_con, self.first_block = residual, skip_con, first_block
        if not first_block:
            self.bn = BatchNorm1d(in_chan, device=device)
        self.dconv = Conv1d(in_chan, in_chan, kernel_size, dilation=dilation,
                            padding=(dilation * (kernel_size - 1)) // 2, groups=in_chan, device=device)
        if skip_con:
            self.sconv = PointwiseConv(in_chan, out_chan, device=device)
        else:
            self.bconv = PointwiseConv(in_chan, out_chan, device=device)

    def forward(self, x: torch.Tensor):
        y = x if self.first_block else self.bn(torch.relu(x))
        y = self.dconv(y)
        res = self.residual and not self.first_block
        if self.skip_con:
            return self.sconv(y), (y + x if res else y)
        y = self.bconv(y)
        return y + x if res else y


class Concat(nn.Module):
    """Audio/video fusion: the video upsampled (nearest) to the audio rate,
    concatenated, then 1x1 + PReLU (reference cnnlayers.py:231-249)."""

    def __init__(self, ain_chan: int, vin_chan: int, out_chan: int, device=None):
        super().__init__()
        self.proj = PointwiseConv(ain_chan + vin_chan, out_chan, device=device)
        self.act = PReLU(device=device)

    def forward(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:  # [B, A, Ta], [B, V, Tv]
        v = interpolate_nearest(v, a.shape[-1])
        return self.act(self.proj(torch.cat([a, v], dim=1)))


class Bottomup(nn.Module):
    """Bottom-up depthwise pyramid (reference cnnlayers.py:400-460):
    returns (residual, the deepest scale, all scales)."""

    def __init__(self, in_chan: int = 128, out_chan: int = 512, upsampling_depth: int = 4, device=None):
        super().__init__()
        self.proj_1x1 = ConvNormAct(in_chan, out_chan, 1, device=device)
        self.spp = nn.ModuleList([ConvNorm(out_chan, out_chan, 5, stride=1 if k == 0 else 2, groups=out_chan,
                                           device=device) for k in range(upsampling_depth)])

    def forward(self, x: torch.Tensor):
        scales = [self.spp[0](self.proj_1x1(x))]
        for conv in self.spp[1:]:
            scales.append(conv(scales[-1]))
        return x, scales[-1], scales


class BottomupConcatTopdown(nn.Module):
    """The pyramid, a top-down sum back to full rate, gLN and a residual
    1x1 (reference cnnlayers.py:506-604, distilled as in the JAX package)."""

    def __init__(self, in_chan: int = 128, out_chan: int = 512, upsampling_depth: int = 4, device=None):
        super().__init__()
        self.bottomup = Bottomup(in_chan, out_chan, upsampling_depth, device=device)
        self.fuse_norm = GlobalLayerNorm(out_chan, eps=1e-8, device=device)
        self.res_conv = PointwiseConv(out_chan, in_chan, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual, top, scales = self.bottomup(x)
        for k in range(len(scales) - 2, -1, -1):
            top = scales[k] + interpolate_nearest(top, scales[k].shape[-1])
        return self.res_conv(self.fuse_norm(top)) + residual


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL relative-position attention on [B, T, D] (reference
    rnnlayers.py:228-328): content scores with the ``u_bias``, position
    scores against the projected ``pos_embedding`` (sinusoidal positions
    by default) with the ``v_bias``, shifted, summed and scaled by
    1/sqrt(dh)."""

    def __init__(self, d_model: int, num_heads: int, device=None):
        super().__init__()
        self.d_model, self.num_heads = d_model, num_heads
        dh = d_model // num_heads
        self.query_proj = nn.Linear(d_model, d_model, device=device)
        self.key_proj = nn.Linear(d_model, d_model, device=device)
        self.value_proj = nn.Linear(d_model, d_model, device=device)
        self.pos_proj = nn.Linear(d_model, d_model, bias=False, device=device)
        self.u_bias = nn.Parameter(torch.zeros(num_heads, dh, device=device))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, dh, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    def forward(self, query, key=None, value=None, pos_embedding=None) -> torch.Tensor:
        key = query if key is None else key
        value = key if value is None else value
        B, T, D = query.shape
        h = self.num_heads
        dh = D // h
        if pos_embedding is None:
            pos_embedding = positions_table(T, D, query.dtype, query.device)[None]
        q = self.query_proj(query).reshape(B, T, h, dh)
        k = self.key_proj(key).reshape(B, -1, h, dh)
        v = self.value_proj(value).reshape(B, -1, h, dh)
        pos = self.pos_proj(pos_embedding).reshape(1, -1, h, dh)
        content = torch.einsum("bqhd,bkhd->bhqk", q + self.u_bias.to(q.dtype), k)
        pos_score = self._rel_shift(torch.einsum("bqhd,bkhd->bhqk", q + self.v_bias.to(q.dtype), pos))
        attn = torch.softmax((content + pos_score) / math.sqrt(dh), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, D)
        return self.out_proj(out)

    @staticmethod
    def _rel_shift(x: torch.Tensor) -> torch.Tensor:
        """The relative-position shift (reference rnnlayers.py:316-328)."""
        B, H, T1, T2 = x.shape
        x = F.pad(x, (1, 0)).reshape(B, H, T2 + 1, T1)[:, :, 1:]
        return x.reshape(B, H, T1, T2)


class MultiHeadedSelfAttentionModule(nn.Module):
    """Pre-norm relative attention + residual (reference rnnlayers.py:329-380)."""

    def __init__(self, d_model: int, num_heads: int, device=None):
        super().__init__()
        self.norm = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.attn = RelativeMultiHeadAttention(d_model, num_heads, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.attn(self.norm(x))


class ConformerConvModule(nn.Module):
    """Conformer conv block on [B, T, D]: LayerNorm, a pointwise conv to
    twice the expanded width and a GLU, the depthwise conv, gLN (eps
    1e-5), swish, a pointwise conv back, and the residual (reference
    rnnlayers.py:490-543)."""

    def __init__(self, in_channels: int, kernel_size: int = 31, expansion_factor: int = 2, device=None):
        super().__init__()
        D, E = in_channels, in_channels * expansion_factor
        self.norm = nn.LayerNorm(D, eps=1e-5, device=device)
        self.pw1 = PointwiseConv(D, 2 * E, device=device)
        self.dw = Conv1d(E, E, kernel_size, padding=(kernel_size - 1) // 2, groups=E, device=device)
        self.bn = GlobalLayerNorm(E, eps=1e-5, device=device)
        self.pw2 = PointwiseConv(E, D, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw1(self.norm(x).transpose(1, 2))
        a, b = y.chunk(2, dim=1)
        y = self.bn(self.dw(a * torch.sigmoid(b)))
        y = self.pw2(y * torch.sigmoid(y))
        return x + y.transpose(1, 2)


class DPRNNLinear(nn.Module):
    """Dual-path block on [B, N, K, S] whose inter-chunk path is a Linear
    over the S chunks (reference rnnlayers.py:793-927): the intra-chunk
    BiLSTM, a Linear and gLN with a residual, then the Linear over S and
    gLN with a residual.  ``num_chunks`` is S, which the JAX module reads
    from its first input."""

    def __init__(self, input_size: int, hidden_size: int, num_chunks: int, device=None):
        super().__init__()
        N, H = input_size, hidden_size
        self.row_rnn = BiLSTM(N, H, device=device)
        self.row_proj = nn.Linear(2 * H, N, device=device)
        self.row_norm = GlobalLayerNorm(N, eps=1e-8, device=device)
        self.col_linear = nn.Linear(num_chunks, num_chunks, device=device)
        self.col_norm = GlobalLayerNorm(N, eps=1e-8, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, K, S = x.shape
        x = x + self.row_norm(_from_rows(self.row_proj(self.row_rnn(_rows(x))), B, S))
        col = self.col_linear(x.permute(0, 2, 1, 3))  # [B, K, N, S], the Linear over S
        return x + self.col_norm(col.permute(0, 2, 1, 3))
