"""Conv + gLN building blocks of the SudoRM-RF family on channels-last
[B, T, C] (counterpart of ``audio_only_speech_separation_tpu/models/blocks/sudo.py``;
reference look2hear/models/utils/sudo_rm_rf.py and tdanet.py:97-116), as
TDANet and AFRCNN use them.

Each keeps look2hear's names: the ``nn.Conv1d`` under ``conv`` (weight
[out, in/groups, k]), the gLN under ``norm`` and the PReLU under ``act``.
The padding is (k - 1) // 2 (times the dilation).  ``UConvBlock`` and
``GC_UConvBlock`` are TasNet's SudoRM-RF separator blocks, on [B, C, T]
outside and channels-last inside; they run no kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import PReLU
from ...ops.conv import conv1d_channels_last
from ...ops.norms import GlobalLayerNorm
from .tac import TAC


class ConvNorm(nn.Module):
    """Conv1d + gLN (eps 1e-8), no activation."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, dilation: int = 1, bias: bool = True, device=None):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, kernel, stride=stride,
                              padding=((kernel - 1) // 2) * dilation, dilation=dilation,
                              groups=groups, bias=bias, device=device)
        self.norm = GlobalLayerNorm(out_channels, eps=1e-8, channels_last=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(conv1d_channels_last(self.conv, x))


class ConvNormAct(ConvNorm):
    """Conv1d + gLN + PReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, device=None):
        super().__init__(in_channels, out_channels, kernel, stride, groups, device=device)
        self.act = PReLU(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(super().forward(x))


class DilatedConvNorm(ConvNorm):
    """Dilated Conv1d + gLN (the pyramid's depthwise convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, device=None):
        super().__init__(in_channels, out_channels, kernel, stride, groups, dilation, device=device)


class _NormAct(nn.Module):
    """gLN (eps 1e-8) + PReLU, look2hear's ``final_norm``."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.norm = GlobalLayerNorm(channels, eps=1e-8, channels_last=True, device=device)
        self.act = PReLU(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(x))


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, 2T, C], nearest (``Upsample(scale_factor=2)``)."""
    return torch.repeat_interleave(x, 2, dim=1)


class UConvBlock(nn.Module):
    """SudoRM-RF's U-ConvBlock (sudo_rm_rf.py:147-206), [B, out_channels, T]
    -> same: a 1x1 up to ``in_channels``, a pyramid of depthwise convs
    (stride 2 below the top), collapsed from the deepest by nearest x2
    upsampling and addition, gLN + PReLU, a 1x1 back and a residual.  Keys:
    ``proj_1x1``, ``spp_dw.{k}``, ``final_norm.{norm, act}``, ``res_conv``."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, upsampling_depth: int = 4,
                 device=None):
        super().__init__()
        C = in_channels
        self.proj_1x1 = ConvNormAct(out_channels, C, 1, device=device)
        self.spp_dw = nn.ModuleList([DilatedConvNorm(C, C, 5, stride=1 if k == 0 else 2, groups=C, device=device)
                                     for k in range(upsampling_depth)])
        self.final_norm = _NormAct(C, device=device)
        self.res_conv = nn.Conv1d(C, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pyramid = [self.spp_dw[0](self.proj_1x1(x.transpose(1, 2)))]  # channels last
        for conv in self.spp_dw[1:]:
            pyramid.append(conv(pyramid[-1]))
        while len(pyramid) > 1:
            up, tgt = upsample2_nearest(pyramid.pop()), pyramid[-1]
            T = tgt.shape[1]
            up = up[:, :T] if up.shape[1] >= T else nn.functional.pad(up, (0, 0, 0, T - up.shape[1]))
            pyramid[-1] = tgt + up
        out = conv1d_channels_last(self.res_conv, self.final_norm(pyramid[0]))
        return out.transpose(1, 2) + x


class GC_UConvBlock(nn.Module):
    """A TAC across ``num_group`` channel groups, then one ``UConvBlock``
    per group (sudo_rm_rf.py:210-236), [B, N, T] -> same.  Keys: ``TAC``,
    ``UBlock``."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, upsampling_depth: int = 4,
                 num_group: int = 16, device=None):
        super().__init__()
        G = num_group
        self.num_group = G
        self.TAC = TAC(out_channels // G, out_channels * 3 // G, device=device)
        self.UBlock = UConvBlock(out_channels // G, in_channels // G, upsampling_depth, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, T = x.shape
        G = self.num_group
        y = self.TAC(x.reshape(B, G, N // G, T)).reshape(B * G, N // G, T)
        return self.UBlock(y).reshape(B, N, T)
