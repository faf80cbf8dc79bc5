"""Conv + gLN building blocks of the SudoRM-RF family on channels-last
[B, T, C] (counterpart of ``audio_only_speech_separation_tpu/models/blocks/sudo.py``;
reference look2hear/models/utils/sudo_rm_rf.py and tdanet.py:97-116), as
TDANet and AFRCNN use them.

Each keeps look2hear's names: the ``nn.Conv1d`` under ``conv`` (weight
[out, in/groups, k]), the gLN under ``norm`` and the PReLU under ``act``.
The padding is (k - 1) // 2 (times the dilation).  ``UConvBlock`` and
``GC_UConvBlock`` are still to port, with the SudoRM-RF TasNet module.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import PReLU
from ...ops.conv import conv1d_channels_last
from ...ops.norms import GlobalLayerNorm


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
