"""Framing, overlap-add and the learned filterbanks (counterpart of
``audio_only_speech_separation_tpu/ops/conv.py``), channels-first only.

The JAX package's ``PointwiseConv`` and depthwise ``Conv1d`` are plain
``torch.nn.Conv1d`` here (kernel 1, and ``groups=C`` with a dilation); their
``state_dict`` layout, weight [out, in/groups, k] plus bias, is the one the
look2hear checkpoints use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def frame_signal(x: torch.Tensor, win: int, stride: int) -> torch.Tensor:
    """x: [B, T] -> frames [B, n, win] (a strided view), n = (T - win)//stride + 1."""
    return x.unfold(1, win, stride)


def overlap_add(frames: torch.Tensor, stride: int) -> torch.Tensor:
    """frames: [B, n, win] -> signal [B, (n-1)*stride + win] by overlap-add.

    For win % stride == 0 the r = win/stride overlapping contributions are
    summed as padded slices in the JAX package's order, so a bf16 sum rounds
    as it does there; otherwise ``F.fold`` does the sum."""
    B, n, win = frames.shape
    T = (n - 1) * stride + win
    if win % stride == 0:
        r = win // stride
        chunks = frames.reshape(B, n, r, stride)
        out = None
        for j in range(r):
            cj = F.pad(chunks[:, :, j], (0, 0, j, r - 1 - j))
            out = cj if out is None else out + cj
        return out.reshape(B, -1)[:, :T]
    folded = F.fold(
        frames.transpose(1, 2), output_size=(1, T), kernel_size=(1, win), stride=(1, stride)
    )
    return folded.reshape(B, T)


def _xavier_(w: torch.Tensor, fan_in: int, fan_out: int, generator) -> None:
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * bound)


class ConvEncoder(nn.Module):
    """Learned analysis filterbank [B, T] -> [B, N, n]: a framed matmul, as
    ``Conv1d(1, N, win, stride, bias=False)``.  Weight ``_filters`` [N, 1, win]."""

    def __init__(self, out_channels: int, win: int, stride: int, device=None):
        super().__init__()
        self.win, self.stride = win, stride
        self._filters = nn.Parameter(torch.empty(out_channels, 1, win, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_(self._filters, self.win, self._filters.shape[0], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frames = frame_signal(x, self.win, self.stride)  # [B, n, win]
        y = torch.matmul(frames, self._filters[:, 0, :].to(x.dtype).t())  # [B, n, N]
        return y.transpose(1, 2)


class ConvDecoder(nn.Module):
    """Learned synthesis filterbank [B, N, n] -> [B, T], as
    ``ConvTranspose1d(N, 1, win, stride, bias=False)``.  Weight ``_filters``
    [N, 1, win]."""

    def __init__(self, in_channels: int, win: int, stride: int, device=None):
        super().__init__()
        self.win, self.stride = win, stride
        self._filters = nn.Parameter(torch.empty(in_channels, 1, win, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _xavier_(self._filters, self._filters.shape[0], self.win, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self._filters[:, 0, :].to(x.dtype)  # [N, win]
        frames = torch.matmul(x.transpose(1, 2), w)  # [B, n, win]
        return overlap_add(frames, self.stride)
