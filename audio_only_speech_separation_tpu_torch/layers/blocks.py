"""Reusable conv, RNN and transformer blocks (counterpart of
``audio_only_speech_separation_tpu/layers/blocks.py``; reference
look2hear/layers/cnnlayers.py and rnnlayers.py).

Torch modules take their input widths at construction, where the JAX
modules infer them.  The LSTMs are ``ops/rnn.py``'s, so a bf16 input on
the card runs the recurrence kernels (K5 or K6 as ``ops/rnn.py::kernel_choice``
picks; the one-direction ``LSTM`` too), and ``TransformerBlockTF``'s attention is
``ops/attention.py::MultiheadAttention`` (K4).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.activations import PReLU
from ..ops.attention import MultiheadAttention, positions_table
from ..ops.conv import Conv1d, PointwiseConv
from ..ops.norms import GlobalLayerNorm, get_norm
from ..ops.resample import interpolate_nearest
from ..ops.rnn import BiLSTM, LSTM


class ConvNorm(nn.Module):
    """Conv1d (padding (kernel - 1) // 2) + gLN (reference cnnlayers.py ConvNorm)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel, stride=stride, padding=(kernel - 1) // 2,
                           groups=groups, bias=use_bias, device=device)
        self.norm = GlobalLayerNorm(out_channels, eps=1e-8, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class ConvNormAct(ConvNorm):
    """Conv1d + gLN + PReLU (reference cnnlayers.py ConvNormAct)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 1, stride: int = 1, groups: int = 1,
                 device=None):
        super().__init__(in_channels, out_channels, kernel, stride, groups, device=device)
        self.act = PReLU(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(super().forward(x))


class Conv1DBlock(nn.Module):
    """TCN block: 1x1 -> PReLU + norm -> dilated depthwise -> PReLU + norm
    -> (residual 1x1, skip 1x1); returns (x + residual, skip) (reference
    cnnlayers.py Conv1DBlock)."""

    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 3, dilation: int = 1,
                 norm_type: str = "gLN", device=None):
        super().__init__()
        norm_cls = get_norm(norm_type)
        self.in_conv = PointwiseConv(in_chan, hid_chan, device=device)
        self.act1 = PReLU(device=device)
        self.norm1 = norm_cls(hid_chan, device=device)
        self.dconv = Conv1d(hid_chan, hid_chan, kernel_size, dilation=dilation,
                            padding=(dilation * (kernel_size - 1)) // 2, groups=hid_chan, device=device)
        self.act2 = PReLU(device=device)
        self.norm2 = norm_cls(hid_chan, device=device)
        self.res_conv = PointwiseConv(hid_chan, in_chan, device=device)
        self.skip_conv = PointwiseConv(hid_chan, in_chan, device=device)

    def forward(self, x: torch.Tensor):
        h = self.norm1(self.act1(self.in_conv(x)))
        h = self.norm2(self.act2(self.dconv(h)))
        return x + self.res_conv(h), self.skip_conv(h)


class FRCNNBlock(nn.Module):
    """Multi-scale fusion block (reference cnnlayers.py:250-399): a
    projection to ``in_channels``, ``upsampling_depth`` resolutions (stride
    2 depthwise), each fused with its neighbours (the finer one strided
    down, the coarser one nearest-upsampled), all brought back to full rate,
    concatenated, projected, and a residual 1x1 to ``out_channels``."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, upsampling_depth: int = 4, device=None):
        super().__init__()
        D, C = upsampling_depth, in_channels
        self.depth = D
        self.proj = ConvNormAct(out_channels, C, 1, device=device)
        self.down = nn.ModuleList([ConvNormAct(C, C, 5, stride=1 if k == 0 else 2, groups=C, device=device)
                                   for k in range(D)])
        self.fuse_down = nn.ModuleList([ConvNorm(C, C, 5, stride=2, groups=C, device=device) for _ in range(1, D)])
        self.concat = nn.ModuleList([ConvNormAct(C * ((i > 0) + 1 + (i + 1 < D)), C, 1, device=device)
                                     for i in range(D)])
        self.last = ConvNormAct(D * C, C, 1, device=device)
        self.res_conv = PointwiseConv(C, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = self.depth
        scales = [self.down[0](self.proj(x))]
        for k in range(1, D):
            scales.append(self.down[k](scales[-1]))
        fused = []
        for i in range(D):
            parts = [self.fuse_down[i - 1](scales[i - 1])] if i > 0 else []
            parts.append(scales[i])
            if i + 1 < D:
                parts.append(interpolate_nearest(scales[i + 1], scales[i].shape[-1]))
            fused.append(self.concat[i](torch.cat(parts, dim=1)))
        T0 = scales[0].shape[-1]
        fused = [fused[0]] + [interpolate_nearest(f, T0) for f in fused[1:]]
        return self.res_conv(self.last(torch.cat(fused, dim=1))) + x


class SingleRNN(nn.Module):
    """(Bi)LSTM returning the hidden states: [B, T, D] -> [B, T, H or 2H]
    (reference rnnlayers.py:40-94)."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = False, device=None):
        super().__init__()
        self.rnn = (BiLSTM if bidirectional else LSTM)(input_size, hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rnn(x)


class LSTMBlockTF(nn.Module):
    """BiLSTM + Linear back to the input width + residual + LayerNorm:
    [B, T, D] -> [B, T, D] (reference rnnlayers.py:95-124)."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.rnn = BiLSTM(input_size, hidden_size, device=device)
        self.proj = nn.Linear(2 * hidden_size, input_size, device=device)
        self.norm = nn.LayerNorm(input_size, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x + self.proj(self.rnn(x)))


class TransformerBlockTF(nn.Module):
    """Post-norm transformer encoder block with sinusoidal positions:
    [B, T, D] -> [B, T, D] (reference rnnlayers.py:544-604)."""

    def __init__(self, d_model: int, n_head: int = 8, d_ffn: int = 1024, use_positions: bool = True,
                 device=None):
        super().__init__()
        self.d_model, self.use_positions = d_model, use_positions
        self.attn = MultiheadAttention(d_model, n_head, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.ffn1 = nn.Linear(d_model, d_ffn, device=device)
        self.ffn2 = nn.Linear(d_ffn, d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_positions:
            x = x + positions_table(x.shape[1], self.d_model, x.dtype, x.device)[None]
        x = self.norm1(x + self.attn(x))
        return self.norm2(x + self.ffn2(torch.relu(self.ffn1(x))))


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, N, K, S] -> the rows [B*S, K, N]."""
    B, N, K, S = x.shape
    return x.permute(0, 3, 2, 1).reshape(B * S, K, N)


def _from_rows(y: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """[B*S, K, N] -> [B, N, K, S]."""
    return y.reshape(B, S, *y.shape[1:]).permute(0, 3, 2, 1)


class DPRNNBlock(nn.Module):
    """One dual-path layer on [B, N, K, S]: the intra-chunk BiLSTM over K,
    a Linear and gLN with a residual, then the inter-chunk (Bi)LSTM over S
    the same way (reference rnnlayers.py:605-792)."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True, device=None):
        super().__init__()
        N, H = input_size, hidden_size
        self.row_rnn = BiLSTM(N, H, device=device)
        self.row_proj = nn.Linear(2 * H, N, device=device)
        self.row_norm = GlobalLayerNorm(N, eps=1e-8, device=device)
        self.col_rnn = (BiLSTM if bidirectional else LSTM)(N, H, device=device)
        self.col_proj = nn.Linear(H * (2 if bidirectional else 1), N, device=device)
        self.col_norm = GlobalLayerNorm(N, eps=1e-8, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, K, S = x.shape
        row = _from_rows(self.row_proj(self.row_rnn(_rows(x))), B, S)
        x = x + self.row_norm(row)
        col = x.permute(0, 2, 3, 1).reshape(B * K, S, N)
        col = self.col_proj(self.col_rnn(col)).reshape(B, K, S, N).permute(0, 3, 1, 2)
        return x + self.col_norm(col)


class DPRNN(nn.Module):
    """``n_repeats`` DPRNNBlocks on [B, N, K, S], then, with
    ``out_channels``, a 1x1 Conv2d without bias to that width."""

    def __init__(self, input_size: int, hidden_size: int, n_repeats: int = 6, out_channels: Optional[int] = None,
                 device=None):
        super().__init__()
        self.blocks = nn.ModuleList([DPRNNBlock(input_size, hidden_size, device=device) for _ in range(n_repeats)])
        self.output = (None if out_channels is None
                       else nn.Conv2d(input_size, out_channels, 1, bias=False, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x if self.output is None else self.output(x)
