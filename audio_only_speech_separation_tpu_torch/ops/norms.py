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

from . import kernels
from .kernels.global_layer_norm import (
    fused_global_layer_norm,
    global_layer_norm_ok,
    global_layer_norm_reference,
)


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


def plain_global_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                            channels_last: bool, group=None) -> torch.Tensor:
    """gLN's plain path: the moments (``global_moments``), the normalised
    float32 values cast to x's dtype, then the per-channel affine in that
    dtype."""
    mean, var = global_moments(x, group)
    y = ((x.float() - mean) / torch.sqrt(var + eps)).to(x.dtype)
    shape = (-1,) if channels_last else (-1,) + (1,) * (x.ndim - 2)
    return y * weight.to(y.dtype).reshape(shape) + bias.to(y.dtype).reshape(shape)


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


class GlobalLayerNorm(nn.Module):
    """gLN: normalise over every axis but the batch, per sample, then a
    per-channel affine.

    Same as ``nn.GroupNorm(1, C)``; eps 1e-8.  The channels are axis 1
    ([B, C, *spatial]), or the last axis with ``channels_last`` ([B,
    *spatial, C], the dual-path row and column norms).  ``group``: the
    statistics of a sample sharded across a sequence-parallel group
    (``global_moments``).  ``residual``: a tensor of x's shape added to the
    result (``residual + gLN(x)``).

    Where ``fuses`` holds the forward is one call of K9
    (``ops/kernels/global_layer_norm.py``, two device operations; inside
    ``kernels.plain_versions()`` its plain version), the residual added in
    its apply pass; every other input takes the plain path."""

    def __init__(self, channels: int, eps: float = 1e-8, channels_last: bool = False, device=None):
        super().__init__()
        self.eps = eps
        self.channels_last = channels_last
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def fuses(self, x: torch.Tensor, group=None, residual: torch.Tensor | None = None) -> bool:
        """Whether the forward on these arguments takes K9: channels last, no
        ``group``; x a bf16 CUDA tensor (``kernels.kernel_input``) of at
        least two axes, contiguous and 16-byte aligned, with C inside
        ``global_layer_norm_ok``; the residual, where given, of x's shape,
        dtype and device, contiguous and aligned; the affines bf16 and
        aligned; and no gradient recorded (grad mode off, or nothing
        requiring one)."""
        w, b = self.weight, self.bias
        return (self.channels_last and group is None and kernels.kernel_input(x) and x.ndim >= 2
                and global_layer_norm_ok(x.shape[-1]) and _aligned(x)
                and w.dtype == torch.bfloat16 and b.dtype == torch.bfloat16 and _aligned(w) and _aligned(b)
                and (residual is None or (residual.shape == x.shape and residual.dtype == x.dtype
                                          and residual.device == x.device and _aligned(residual)))
                and not (torch.is_grad_enabled()
                         and (x.requires_grad or w.requires_grad or b.requires_grad
                              or (residual is not None and residual.requires_grad))))

    def forward(self, x: torch.Tensor, group=None, residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.fuses(x, group, residual):
            gln = kernels.pick(fused_global_layer_norm, global_layer_norm_reference)
            return gln(x, self.weight, self.bias, self.eps, residual)
        y = plain_global_layer_norm(x, self.weight, self.bias, self.eps, self.channels_last, group)
        return y if residual is None else residual + y


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
