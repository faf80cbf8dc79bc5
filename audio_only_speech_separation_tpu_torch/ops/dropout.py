"""Dropout and stochastic depth with their own generators (counterpart of
``audio_only_speech_separation_tpu/ops/dropout.py`` and of flax's
``nn.Dropout``; reference look2hear/models/tdanet.py:15-35).

The JAX package draws every mask from the ``dropout`` stream of a key that
its Trainer folds from ``seed`` and the step.  Here each module draws from
a ``torch.Generator`` of its own on the input's device, so no mask comes
from torch's process-wide generator: ``seed_generators(model, seed, step,
rank)`` seeds every such module of a model from (seed, step, rank), and
``train.Trainer`` calls it at the start of every step's forward.  So a
step's masks depend on the seed, the global step and the data-parallel
rank alone: a run resumed from a checkpoint draws what the uninterrupted
run draws, and a forward recomputed for the backward (remat) draws the
masks of the first pass.  The masks are not the JAX package's: the two
frameworks have different generators, and the JAX package draws one mask
over the global batch where each rank here draws its own.  Neither module
holds parameters or buffers, so state dicts keep their keys.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class _Draws(nn.Module):
    """A module that draws masks while training from a generator of its own,
    made on the input's device at the first draw from ``seed``."""

    def __init__(self, rate: float = 0.0, generator: torch.Generator | None = None):
        super().__init__()
        self.rate = rate
        self.seed = 0
        self.generator = generator

    def reseed(self, seed: int) -> None:
        """Start the draws again from ``seed``."""
        self.seed = seed
        if self.generator is not None:
            self.generator.manual_seed(seed)

    def uniform(self, shape, device: torch.device) -> torch.Tensor:
        """f32 U[0, 1) of ``shape`` on ``device`` from this module's generator."""
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device).manual_seed(self.seed)
        return torch.rand(shape, generator=self.generator, device=device)

    def __getstate__(self):
        # a copy (``copy.deepcopy``, pickling) starts again from ``seed``
        return dict(super().__getstate__(), generator=None)


class Dropout(_Draws):
    """Elementwise dropout while training: each element is zeroed with
    probability ``rate``, the others scaled by 1/(1 - rate).  The identity
    in eval mode or at rate 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = self.uniform(x.shape, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(_Draws):
    """Per-sample gating of a residual branch while training: with
    probability ``rate`` the branch is zeroed for a batch element, otherwise
    scaled by 1/(1 - rate).  The identity in eval mode or at rate 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = self.uniform(shape, x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def seed_generators(model: nn.Module, seed: int, step: int | None = None, rank: int = 0) -> int:
    """Reseed every ``Dropout`` and ``DropPath`` of ``model`` from ``seed``
    (and the training ``step`` and data-parallel ``rank``, when a step is
    given): each its own seed, drawn in module order from numpy's
    ``SeedSequence`` of (seed, step, rank).  Returns how many it
    reseeded."""
    draws = [m for m in model.modules() if isinstance(m, _Draws)]
    entropy = (seed,) if step is None else (seed, step, rank)
    seeds = np.random.SeedSequence(entropy).generate_state(len(draws), np.uint64) >> np.uint64(2)
    for m, s in zip(draws, seeds.tolist()):
        m.reseed(s)
    return len(draws)
