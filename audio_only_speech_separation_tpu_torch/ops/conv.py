"""Framing, overlap-add and the learned filterbanks (counterpart of
``audio_only_speech_separation_tpu/ops/conv.py``): channels-first
framing and overlap-add, and their channels-last duals on axis 1
(``frame_axis1``, ``overlap_add_axis1``) for Sandglasset's chunking.

The JAX package's conv modules are torch's here: ``Conv1d`` (symmetric
integer padding, stride, dilation, groups) and ``ConvTranspose1d`` (no
padding: output length (T - 1) * stride + k) are ``nn.Conv1d`` and
``nn.ConvTranspose1d``, and ``PointwiseConv`` is an ``nn.Conv1d`` of kernel
1.  Their ``state_dict`` layout, weight [out, in/groups, k] ([in, out, k]
transposed) plus bias, is the one the look2hear checkpoints use;
``utils/jax_import.py`` maps the flax kernels [k, in/groups, out] and
[in, out] onto it.
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


def frame_axis1(x: torch.Tensor, win: int, stride: int) -> torch.Tensor:
    """x: [B, T, D] -> frames [B, n, win, D] over axis 1, the channels
    trailing (a strided view), n = (T - win)//stride + 1."""
    return x.unfold(1, win, stride).transpose(2, 3)


def overlap_add_axis1(frames: torch.Tensor, stride: int) -> torch.Tensor:
    """frames: [B, n, win, D] -> [B, (n-1)*stride + win, D]: overlap-add
    over axis 1, the channels-last dual of ``overlap_add`` (for win %
    stride == 0 the padded slices summed in the JAX package's order)."""
    B, n, win, D = frames.shape
    T = (n - 1) * stride + win
    if win % stride == 0:
        r = win // stride
        chunks = frames.reshape(B, n, r, stride, D)
        out = None
        for j in range(r):
            cj = F.pad(chunks[:, :, j], (0, 0, 0, 0, j, r - 1 - j))
            out = cj if out is None else out + cj
        return out.reshape(B, -1, D)[:, :T]
    idx = (torch.arange(n)[:, None] * stride + torch.arange(win)[None, :]).reshape(-1).to(frames.device)
    out = frames.new_zeros(B, T, D)
    return out.index_add_(1, idx, frames.reshape(B, n * win, D))


Conv1d = nn.Conv1d
ConvTranspose1d = nn.ConvTranspose1d


class PointwiseConv(nn.Conv1d):
    """1x1 conv on [B, C, T]: ``nn.Conv1d(in_channels, out_channels, 1)``."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True, device=None):
        super().__init__(in_channels, out_channels, 1, bias=bias, device=device)


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


def conv1d_channels_last(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (its weights, stride, padding, dilation and groups) on a
    channels-last [B, T, C] input, in x's dtype -> [B, T', out].  A dense
    1x1 is one product over the channels, a depthwise 1x1 a per-channel
    scale; any other conv runs as ``F.conv1d`` on the transposed input."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    pointwise = conv.kernel_size == (1,) and conv.stride == (1,) and conv.padding == (0,)
    if pointwise and conv.groups == 1:
        y = torch.matmul(x, w[:, :, 0].t())
    elif pointwise and conv.groups == conv.in_channels == conv.out_channels:
        y = x * w[:, 0, 0]
    else:
        y = F.conv1d(x.transpose(1, 2), w, b, conv.stride, conv.padding, conv.dilation, conv.groups)
        return y.transpose(1, 2)
    return y if b is None else y + b


def depthwise_conv_channels_last(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A depthwise ``conv`` (groups == channels, stride 1; any kernel size,
    dilation and padding) on a channels-last [B, T, C] input, in x's dtype,
    as a sum of shifted taps with no transpose: ``y[t] = bias + sum_j w_j *
    x_padded[t + j * dilation]`` -> [B, T', C] (the JAX package's
    channels-last depthwise ``Conv1d``)."""
    if conv.groups != conv.in_channels or conv.in_channels != conv.out_channels or conv.stride != (1,):
        raise ValueError("depthwise_conv_channels_last takes a depthwise conv of stride 1")
    (k,), (d,), (p,) = conv.kernel_size, conv.dilation, conv.padding
    w = conv.weight[:, 0, :].to(x.dtype)  # [C, k]
    xp = F.pad(x, (0, 0, p, p))
    T = xp.shape[1] - d * (k - 1)
    y = None
    for j in range(k):
        tap = xp[:, j * d: j * d + T] * w[:, j]
        y = tap if y is None else y + tap
    return y if conv.bias is None else y + conv.bias.to(x.dtype)

