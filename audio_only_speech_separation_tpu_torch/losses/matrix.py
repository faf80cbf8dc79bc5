"""The NegSDR loss family (counterpart of
``audio_only_speech_separation_tpu/losses/matrix.py``; reference
look2hear/losses/matrix.py:13-163).

Optional zero-mean, the SI-SDR projection (or raw SNR), eps = 1e-8 inside
both the energy ratio and the log.  Every function takes an optional
``mask`` [B, T] for variable-length batches.
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-8
_SDR_TYPES = ("snr", "sisdr", "sdsdr")


def _check_type(sdr_type: str) -> None:
    if sdr_type not in _SDR_TYPES:
        raise ValueError(f"sdr_type must be one of {_SDR_TYPES}, got {sdr_type!r}")


def _mask_like(x, mask):
    return mask[..., None, :] if x.ndim > mask.ndim else mask


def _zero_mean(x, mask: Optional[torch.Tensor]):
    if mask is None:
        return x - x.mean(dim=-1, keepdim=True)
    m = _mask_like(x, mask)
    denom = torch.clamp(m.sum(dim=-1, keepdim=True), min=1.0)
    mean = (x * m).sum(dim=-1, keepdim=True) / denom
    return (x - mean) * m


def _prepare(ests, targets, mask, zero_mean: bool):
    if zero_mean:
        return _zero_mean(ests, mask), _zero_mean(targets, mask)
    if mask is not None:
        return ests * _mask_like(ests, mask), targets * _mask_like(targets, mask)
    return ests, targets


def _ratio(s_est, s_tgt, sdr_type: str, eps: float, take_log: bool):
    """-SDR over the last axis of broadcast-compatible estimates/targets."""
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (s_est * s_tgt).sum(dim=-1, keepdim=True)
        tgt_energy = s_tgt.square().sum(dim=-1, keepdim=True) + eps
        proj = dot * s_tgt / tgt_energy
    else:
        proj = torch.broadcast_to(s_tgt, torch.broadcast_shapes(s_est.shape, s_tgt.shape))
    e_noise = s_est - s_tgt if sdr_type in ("sdsdr", "snr") else s_est - proj
    ratio = proj.square().sum(dim=-1) / (e_noise.square().sum(dim=-1) + eps)
    if take_log:
        ratio = 10.0 * torch.log10(ratio + eps)
    return -ratio


class PairwiseNegSDR:
    """All-pairs -SDR matrix [B, n_src, n_src]; entry [b, est, tgt]."""

    def __init__(self, sdr_type: str, zero_mean: bool = True, take_log: bool = True, EPS: float = EPS):
        _check_type(sdr_type)
        self.sdr_type, self.zero_mean, self.take_log, self.eps = sdr_type, zero_mean, take_log, EPS

    def __call__(self, ests, targets, mask: Optional[torch.Tensor] = None):
        if ests.shape != targets.shape or ests.ndim != 3:
            raise ValueError(f"Inputs must be [batch, n_src, time], got {tuple(targets.shape)} "
                             f"and {tuple(ests.shape)}")
        ests, targets = _prepare(ests, targets, mask, self.zero_mean)
        return _ratio(ests[:, :, None, :], targets[:, None, :, :], self.sdr_type, self.eps,
                      self.take_log)


class SingleSrcNegSDR:
    """-SDR per batch item on [B, T] pairs."""

    def __init__(self, sdr_type: str, zero_mean: bool = True, take_log: bool = True,
                 reduction: str = "none", EPS: float = EPS):
        _check_type(sdr_type)
        if reduction not in ("none", "mean"):
            raise ValueError(f"reduction must be 'none' or 'mean', got {reduction!r}")
        self.sdr_type, self.zero_mean, self.take_log, self.eps = sdr_type, zero_mean, take_log, EPS
        self.reduction = reduction

    def __call__(self, ests, targets, mask: Optional[torch.Tensor] = None):
        if ests.shape != targets.shape or ests.ndim != 2:
            raise ValueError(f"Inputs must be [batch, time], got {tuple(targets.shape)} "
                             f"and {tuple(ests.shape)}")
        ests, targets = _prepare(ests, targets, mask, self.zero_mean)
        losses = _ratio(ests, targets, self.sdr_type, self.eps, self.take_log)
        return losses.mean() if self.reduction == "mean" else losses


class MultiSrcNegSDR:
    """Fixed-order -SDR averaged over sources, per batch item."""

    def __init__(self, sdr_type: str, zero_mean: bool = True, take_log: bool = True, EPS: float = EPS):
        _check_type(sdr_type)
        self.sdr_type, self.zero_mean, self.take_log, self.eps = sdr_type, zero_mean, take_log, EPS

    def __call__(self, ests, targets, mask: Optional[torch.Tensor] = None):
        if ests.shape != targets.shape or ests.ndim != 3:
            raise ValueError(f"Inputs must be [batch, n_src, time], got {tuple(targets.shape)} "
                             f"and {tuple(ests.shape)}")
        ests, targets = _prepare(ests, targets, mask, self.zero_mean)
        return _ratio(ests, targets, self.sdr_type, self.eps, self.take_log).mean(dim=-1)


# Aliases (reference matrix.py:154-163)
pairwise_neg_sisdr = PairwiseNegSDR("sisdr")
pairwise_neg_sdsdr = PairwiseNegSDR("sdsdr")
pairwise_neg_snr = PairwiseNegSDR("snr")
singlesrc_neg_sisdr = SingleSrcNegSDR("sisdr")
singlesrc_neg_sdsdr = SingleSrcNegSDR("sdsdr")
singlesrc_neg_snr = SingleSrcNegSDR("snr")
multisrc_neg_sisdr = MultiSrcNegSDR("sisdr")
multisrc_neg_sdsdr = MultiSrcNegSDR("sdsdr")
multisrc_neg_snr = MultiSrcNegSDR("snr")
