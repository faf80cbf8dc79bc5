"""The norms on [B, C, T] (counterpart of
``audio_only_speech_separation_tpu/ops/norms.py``): gLN, cLN, the
per-frame LN, BatchNorm with running statistics, and the registry
``get_norm`` with the JAX package's names.

gLN, cLN and LN keep the affine pair as ``weight``/``bias`` of shape [C],
the ``nn.GroupNorm(1, C)`` names, and compute their statistics in float32.
"""

from __future__ import annotations

import torch
from torch import nn


def _moments(x: torch.Tensor, axes):
    """Mean and variance over ``axes``, in float32, in the shifted-data
    single pass the JAX package takes: with c the first element along
    ``axes``, var = E[(x-c)^2] - (E[x-c])^2, which keeps the cancellation
    small whatever the data's offset; the variance clamped at 0."""
    x32 = x.float()
    c = x32[tuple(slice(0, 1) if i in axes else slice(None) for i in range(x.ndim))]
    xc = x32 - c
    mean_c = xc.mean(dim=axes, keepdim=True)
    var = torch.clamp(xc.square().mean(dim=axes, keepdim=True) - mean_c.square(), min=0.0)
    return mean_c + c, var


def global_moments(x: torch.Tensor, group=None):
    """Per-sample mean and variance over every axis but 0 (``_moments``).
    Under ``group`` (sequence parallelism: each rank of the group holds a
    share of every sample) each rank's moments, shifted by its own first
    element, are combined across the group
    (``parallel.sequence.combine_moments``), so every rank gets the whole
    sample's."""
    mean, var = _moments(x, tuple(range(1, x.ndim)))
    if group is None:
        return mean, var
    from ..parallel.sequence import combine_moments

    return combine_moments(mean, var, x[0].numel(), group)


class GlobalLayerNorm(nn.Module):
    """gLN: normalise over every axis but the batch, per sample, then a
    per-channel affine.

    Same as ``nn.GroupNorm(1, C)``; eps 1e-8.  The channels are axis 1
    ([B, C, *spatial]), or the last axis with ``channels_last`` ([B,
    *spatial, C], the dual-path row and column norms).  ``group``: the
    statistics of a sample sharded across a sequence-parallel group
    (``global_moments``)."""

    def __init__(self, channels: int, eps: float = 1e-8, channels_last: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.channels_last = channels_last
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        mean, var = global_moments(x, group)
        y = ((x.float() - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        shape = (-1,) if self.channels_last else (-1,) + (1,) * (x.ndim - 2)
        return y * self.weight.to(y.dtype).reshape(shape) + self.bias.to(y.dtype).reshape(shape)


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


class FrameLayerNorm(nn.Module):
    """LN: per-frame norm over the channels of [B, C, *spatial] at each
    position (``_moments`` over axis 1), then a per-channel affine; eps
    1e-8 (the reference's ``ChannelLN``)."""

    def __init__(self, channels: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = _moments(x, (1,))
        y = ((x.float() - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        shape = (-1,) + (1,) * (x.ndim - 2)
        return y * self.weight.to(y.dtype).reshape(shape) + self.bias.to(y.dtype).reshape(shape)


# The reference names the per-frame channel norm twice (the JAX package's
# ops/norms.py:91-93); one class here.
ChannelLayerNorm = FrameLayerNorm


class BatchNorm1d(nn.BatchNorm1d):
    """bN: ``nn.BatchNorm1d`` over the channels of [B, C, T] (eps 1e-5,
    momentum 0.1): batch statistics and an update of ``running_mean`` /
    ``running_var`` in training mode, the running statistics in eval mode.

    The running variance is updated with the unbiased batch variance, as
    torch (the reference's layer) does; the JAX package's flax BatchNorm
    takes the biased one there, and both normalise with the biased one."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1, device=None):
        super().__init__(channels, eps=eps, momentum=momentum, device=device)


_NORMS = {
    "gLN": GlobalLayerNorm,
    "cLN": CumulativeLayerNorm,
    "LN": FrameLayerNorm,
    "bN": BatchNorm1d,
    "GlobalLN": GlobalLayerNorm,
    "ChannelLN": FrameLayerNorm,
    "CumulateLN": CumulativeLayerNorm,
}


def get_norm(identifier):
    """A norm class from its name (the JAX registry's), a class or callable
    itself, or None; ValueError for anything else."""
    if identifier is None or callable(identifier):
        return identifier
    if isinstance(identifier, str) and identifier in _NORMS:
        return _NORMS[identifier]
    raise ValueError(f"Could not interpret normalization identifier: {identifier}")
