"""gLN and cLN on [B, C, T] (counterpart of
``audio_only_speech_separation_tpu/ops/norms.py``).

Both keep the affine pair as ``weight``/``bias`` of shape [C], the
``nn.GroupNorm(1, C)`` names, and compute their statistics in float32.
"""

from __future__ import annotations

import torch
from torch import nn


def global_moments(x: torch.Tensor):
    """Per-sample mean and variance over every axis but 0, in float32.

    Shifted-data single pass, as the JAX package does it: with c one
    element of each sample, var = E[(x-c)^2] - (E[x-c])^2, which keeps the
    cancellation small whatever the data's offset.  The variance is clamped
    at 0."""
    x32 = x.float()
    axes = tuple(range(1, x.ndim))
    c = x32[(slice(None),) + (slice(0, 1),) * (x.ndim - 1)]
    xc = x32 - c
    mean_c = xc.mean(dim=axes, keepdim=True)
    var = torch.clamp(xc.square().mean(dim=axes, keepdim=True) - mean_c.square(), min=0.0)
    return mean_c + c, var


class GlobalLayerNorm(nn.Module):
    """gLN: normalise over (C, T) per sample, then a per-channel affine.

    Same as ``nn.GroupNorm(1, C)``; eps 1e-8."""

    def __init__(self, channels: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        mean, var = global_moments(x)
        y = ((x.float() - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        return y * self.weight.to(y.dtype)[:, None] + self.bias.to(y.dtype)[:, None]


class CumulativeLayerNorm(nn.Module):
    """cLN: causal norm; statistics at frame t run over the channels of
    frames 0..t (cumulative sums), in float32."""

    def __init__(self, channels: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, T]
        _, C, T = x.shape
        xf = x.float()
        cum_sum = torch.cumsum(xf.sum(dim=1), dim=1)  # [B, T]
        cum_pow = torch.cumsum(xf.square().sum(dim=1), dim=1)
        cnt = torch.arange(1, T + 1, device=x.device, dtype=torch.float32) * C
        cum_mean = cum_sum / cnt
        cum_var = (cum_pow - 2.0 * cum_mean * cum_sum) / cnt + cum_mean.square()
        cum_std = torch.sqrt(torch.clamp(cum_var, min=0.0) + self.eps)
        y = ((xf - cum_mean[:, None, :]) / cum_std[:, None, :]).to(x.dtype)
        return y * self.weight.to(y.dtype)[:, None] + self.bias.to(y.dtype)[:, None]
