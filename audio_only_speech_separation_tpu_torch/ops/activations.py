"""PReLU (counterpart of ``audio_only_speech_separation_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
from torch import nn


class PReLU(nn.Module):
    """PReLU with one shared slope, torch ``nn.PReLU()`` default (init 0.25).

    The slope is ``weight`` ([1]), the look2hear ``state_dict`` name."""

    def __init__(self, init: float = 0.25, device=None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight[0].to(x.dtype)
        return torch.where(x >= 0, x, a * x)
