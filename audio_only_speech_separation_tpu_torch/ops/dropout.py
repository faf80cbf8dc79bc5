"""Stochastic depth (counterpart of ``audio_only_speech_separation_tpu/ops/dropout.py``;
reference look2hear/models/tdanet.py:15-35)."""

from __future__ import annotations

import torch
from torch import nn


class DropPath(nn.Module):
    """Per-sample gating of a residual branch while training: with
    probability ``rate`` the branch is zeroed for a batch element, otherwise
    scaled by 1/(1 - rate).  The identity in eval mode or at rate 0.  The
    draws come from ``generator`` (a CPU ``torch.Generator``; none: one
    seeded 0), so a training run repeats."""

    def __init__(self, rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = (torch.rand(shape, generator=self.generator) < keep).to(x.device)
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
