"""PReLU and the activation registry ``get_activation`` (counterpart of
``audio_only_speech_separation_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
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


# The JAX registry's functions with jax.nn's defaults: leaky_relu's slope
# 0.01, softmax over the last axis, gelu's tanh approximation
_ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": F.relu,
    "leaky_relu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def get_activation(identifier):
    """An activation from its name (the JAX registry's; "prelu" gives the
    ``PReLU`` class), a callable itself, or None; ValueError for anything
    else."""
    if identifier is None or callable(identifier):
        return identifier
    if identifier == "prelu":
        return PReLU
    if isinstance(identifier, str) and identifier in _ACTIVATIONS:
        return _ACTIVATIONS[identifier]
    raise ValueError(f"Could not interpret activation identifier: {identifier}")
