"""Optimizer registry over ``torch.optim`` (counterpart of
``audio_only_speech_separation_tpu/train/optimizers.py``; reference
look2hear/system/optimizers.py).

``make_optimizer`` returns an ``Optimizer``: a torch optimizer over the
given parameters plus optional clipping of the global gradient norm,
which it applies in ``step`` as optax's ``clip_by_global_norm`` does
(scale by max_norm / norm when the norm reaches max_norm).  The learning
rate is read and written with ``get_learning_rate`` / ``set_learning_rate``,
as a scheduler does between epochs.

Names of the JAX registry that torch does not ship (lamb, novograd, yogi,
lars, sm3, adafactor, ranger, adabelief) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

_NOT_IN_TORCH = ("lamb", "novograd", "yogi", "lars", "sm3", "adafactor", "ranger", "adabelief")
_KNOWN = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "adamax", "radam")


def _base(name: str, params, lr: float, weight_decay: float, **kw) -> torch.optim.Optimizer:
    name = name.lower()
    wd = weight_decay or 0.0
    if name in ("adam", "adamw"):
        # decoupled weight decay whenever there is one, as optax.adamw
        if name == "adamw" or wd:
            return torch.optim.AdamW(params, lr=lr, weight_decay=wd, **kw)
        return torch.optim.Adam(params, lr=lr, **kw)
    classes = {"sgd": torch.optim.SGD, "rmsprop": torch.optim.RMSprop,
               "adagrad": torch.optim.Adagrad, "adamax": torch.optim.Adamax,
               "radam": torch.optim.RAdam}
    if name in classes:
        return classes[name](params, lr=lr, weight_decay=wd, **kw)
    if name in _NOT_IN_TORCH:
        raise NotImplementedError(f"optimizer {name!r} has no torch.optim counterpart in the port yet")
    raise ValueError(f"Unknown optimizer {name!r}; known: {', '.join(_KNOWN)}")


class Optimizer:
    """A torch optimizer with global-norm gradient clipping in ``step``."""

    def __init__(self, opt: torch.optim.Optimizer, grad_clip: Optional[float] = None):
        self.opt = opt
        self.grad_clip = grad_clip

    @property
    def params(self):
        return [p for group in self.opt.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def clip_grads(self) -> Optional[torch.Tensor]:
        """Scale the gradients by min(1, max_norm / global_norm); returns
        the norm before clipping (None without clipping)."""
        if not self.grad_clip:
            return None
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
        for g in grads:
            g.mul_(scale)
        return norm

    def step(self) -> None:
        self.clip_grads()
        self.opt.step()

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state) -> None:
        self.opt.load_state_dict(state)


def make_optimizer(params: Iterable[torch.nn.Parameter], optim_name: str = "adam",
                   lr: float = 1e-3, weight_decay: float = 0.0,
                   grad_clip: Optional[float] = None, **kw) -> Optimizer:
    """The optimizer of a training run: ``optim_name`` over ``params``,
    clipping the global gradient norm at ``grad_clip`` when it is set."""
    return Optimizer(_base(optim_name, list(params), lr, weight_decay, **kw), grad_clip)


def get_learning_rate(optimizer: Optimizer) -> float:
    return float(optimizer.opt.param_groups[0]["lr"])


def set_learning_rate(optimizer: Optimizer, lr: float) -> None:
    for group in optimizer.opt.param_groups:
        group["lr"] = float(lr)
