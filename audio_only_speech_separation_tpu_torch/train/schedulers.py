"""Learning-rate schedulers as host-side state machines (counterpart of
``audio_only_speech_separation_tpu/train/schedulers.py``).

The reference drives torch ``ReduceLROnPlateau(patience=15, factor=0.5)``
from Lightning's val-loss monitor (audio_train.py:54-56) and ships a Noam
warm-up (utils/transformer_optimizer.py:3-57).  Each scheduler observes an
epoch metric (or, for Noam, an optimizer step) and returns the next LR;
the trainer writes it into the optimizer.  The state machines are the JAX
package's, step for step.
"""

from __future__ import annotations

import math
from typing import Optional


class _Stateful:
    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, state):
        self.__dict__.update(state)


class ReduceLROnPlateau(_Stateful):
    """torch-compatible plateau scheduler (mode min|max, factor, patience,
    threshold rel|abs, cooldown, min_lr)."""

    def __init__(self, lr: float, mode: str = "min", factor: float = 0.5, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, **_unused):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, current: float) -> bool:
        if self.best is None:
            return True
        eps = self.threshold * abs(self.best) if self.threshold_mode == "rel" else self.threshold
        if self.mode == "min":
            return current < self.best - eps
        return current > self.best + eps

    def step(self, metric: float) -> float:
        """Observe one epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
        return self.lr


class StepLR(_Stateful):
    def __init__(self, lr: float, step_size: int, gamma: float = 0.1, **_):
        self.base_lr = lr
        self.lr = lr
        self.step_size = step_size
        self.gamma = gamma
        self.epoch = 0

    def step(self, metric: float = 0.0) -> float:
        self.epoch += 1
        self.lr = self.base_lr * self.gamma ** (self.epoch // self.step_size)
        return self.lr


class ExponentialLR(_Stateful):
    """lr times ``gamma`` every epoch."""

    def __init__(self, lr: float, gamma: float = 0.95, **_):
        self.lr = lr
        self.gamma = gamma

    def step(self, metric: float = 0.0) -> float:
        self.lr *= self.gamma
        return self.lr


class CosineAnnealingLR(_Stateful):
    """eta_min + (lr - eta_min) (1 + cos(pi epoch / T_max)) / 2 after each
    epoch."""

    def __init__(self, lr: float, T_max: int, eta_min: float = 0.0, **_):
        self.base_lr = lr
        self.lr = lr
        self.T_max = T_max
        self.eta_min = eta_min
        self.epoch = 0

    def step(self, metric: float = 0.0) -> float:
        self.epoch += 1
        self.lr = self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.epoch / self.T_max))
        return self.lr


class NoamLR(_Stateful):
    """Transformer warm-up (reference utils/transformer_optimizer.py:3-57),
    stepped per optimizer step through ``step_batch``."""

    def __init__(self, lr: float, d_model: int = 256, warmup_steps: int = 4000,
                 scale: float = 1.0, **_):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.scale = scale
        self.n_steps = 0
        self.lr = 0.0

    def step_batch(self) -> float:
        self.n_steps += 1
        self.lr = self.scale * self.d_model ** -0.5 * min(
            self.n_steps ** -0.5, self.n_steps * self.warmup_steps ** -1.5)
        return self.lr

    def step(self, metric: float = 0.0) -> float:
        return self.lr


_SCHEDULERS = {"ReduceLROnPlateau": ReduceLROnPlateau, "StepLR": StepLR, "ExponentialLR": ExponentialLR,
               "CosineAnnealingLR": CosineAnnealingLR, "NoamLR": NoamLR}


def make_scheduler(sche_name: str, lr: float, **sche_config):
    if sche_name not in _SCHEDULERS:
        raise ValueError(f"Unknown scheduler {sche_name!r}; known: {sorted(_SCHEDULERS)}")
    return _SCHEDULERS[sche_name](lr=lr, **sche_config)
