"""Dilated depthwise TCN separators (counterpart of
``audio_only_speech_separation_tpu/models/blocks/tcn.py``; reference
look2hear/models/utils/tcn.py), on [B, C, T].

``DepthConv1d``: 1x1 expand, PReLU + gLN, dilated depthwise conv, PReLU +
gLN, then 1x1 residual and skip outputs.  ``TCN`` stacks ``layer`` x
``stack`` of them with dilations 2^i after gLN and a 1x1 bottleneck, and
maps the sum of the skips through PReLU and a 1x1; ``GC_TCN`` runs a TAC
across channel groups before each block and a per-group 1x1 head.  The
JAX modules' ``skip`` and ``dilated`` switches are left out: TasNet builds
only their defaults.  No kernel: in bf16 on the card they are the modules
cast to bf16.  Keys (under TasNet's ``seq_model.tcn``): ``LN``, ``BN``,
``TCN.{i}.{conv1d, nonlinearity1, reg1, dconv1d, nonlinearity2, reg2,
res_out, skip_out}``, ``output.{0,1}`` (``TCN``) or ``TAC.{i}`` and
``output`` (``GC_TCN``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import PReLU
from ...ops.norms import GlobalLayerNorm
from .tac import TAC


def pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``conv`` on [B, C, T] as one product, in x's dtype."""
    y = torch.matmul(conv.weight[:, :, 0].to(x.dtype), x)
    return y if conv.bias is None else y + conv.bias.to(x.dtype)[:, None]


class DepthConv1d(nn.Module):
    """[B, C, T] -> (residual, skip) (tcn.py:6-37)."""

    def __init__(self, input_channel: int, hidden_channel: int, kernel: int, dilation: int,
                 device=None):
        super().__init__()
        self.conv1d = nn.Conv1d(input_channel, hidden_channel, 1, device=device)
        self.dconv1d = nn.Conv1d(hidden_channel, hidden_channel, kernel, dilation=dilation,
                                 groups=hidden_channel, padding=dilation, device=device)
        self.res_out = nn.Conv1d(hidden_channel, input_channel, 1, device=device)
        self.skip_out = nn.Conv1d(hidden_channel, input_channel, 1, device=device)
        self.nonlinearity1, self.nonlinearity2 = PReLU(device=device), PReLU(device=device)
        self.reg1 = GlobalLayerNorm(hidden_channel, eps=1e-8, device=device)
        self.reg2 = GlobalLayerNorm(hidden_channel, eps=1e-8, device=device)

    def forward(self, x: torch.Tensor):
        h = self.reg1(self.nonlinearity1(pointwise(self.conv1d, x)))
        h = self.reg2(self.nonlinearity2(self.dconv1d(h)))
        return pointwise(self.res_out, h), pointwise(self.skip_out, h)


def _blocks(channels, hidden, layer, stack, kernel, device) -> nn.ModuleList:
    return nn.ModuleList([DepthConv1d(channels, hidden, kernel, dilation=2 ** i, device=device)
                          for _ in range(stack) for i in range(layer)])


class TCN(nn.Module):
    """TasNet's TCN separator (tcn.py:41-97): [B, N, T] -> [B, output_dim, T]."""

    def __init__(self, input_dim: int, output_dim: int, BN_dim: int, hidden_dim: int, layer: int,
                 stack: int, kernel: int = 3, device=None):
        super().__init__()
        self.LN = GlobalLayerNorm(input_dim, eps=1e-8, device=device)
        self.BN = nn.Conv1d(input_dim, BN_dim, 1, device=device)
        self.TCN = _blocks(BN_dim, hidden_dim, layer, stack, kernel, device)
        self.output = nn.Sequential(PReLU(device=device), nn.Conv1d(BN_dim, output_dim, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = pointwise(self.BN, self.LN(x))
        skip_sum = 0.0
        for block in self.TCN:
            residual, skip = block(out)
            skip_sum = skip_sum + skip
            out = out + residual
        return pointwise(self.output[1], self.output[0](skip_sum))


class GC_TCN(nn.Module):
    """Group-communication TCN (tcn.py:101-164): a TAC before every block on
    ``num_group`` channel groups, [B, N, T] -> [B, output_dim, T]."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int, layer: int, stack: int,
                 kernel: int = 3, num_group: int = 2, device=None):
        super().__init__()
        G = num_group
        n, h = input_dim // G, hidden_dim // G
        self.num_group = G
        self.TAC = nn.ModuleList([TAC(n, h * 3, device=device) for _ in range(layer * stack)])
        self.TCN = _blocks(n, h, layer, stack, kernel, device)
        self.output = nn.Conv1d(n, output_dim // G, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, T = x.shape
        G = self.num_group
        out = x.reshape(B, G, N // G, T)
        skip_sum = 0.0
        for tac, block in zip(self.TAC, self.TCN):
            flat = tac(out).reshape(B * G, N // G, T)
            residual, skip = block(flat)
            skip_sum = skip_sum + skip
            out = (flat + residual).reshape(B, G, N // G, T)
        return pointwise(self.output, skip_sum).reshape(B, -1, T)
