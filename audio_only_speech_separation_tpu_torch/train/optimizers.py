"""Optimizer registry (counterpart of
``audio_only_speech_separation_tpu/train/optimizers.py``; reference
look2hear/system/optimizers.py).

``make_optimizer`` returns an ``Optimizer``: an update rule over the given
parameters plus optional clipping of the global gradient norm, which it
applies in ``step`` as optax's ``clip_by_global_norm`` does (scale by
max_norm / norm when the norm reaches max_norm).  The learning rate is read
and written with ``get_learning_rate`` / ``set_learning_rate``, as a
scheduler does between epochs.

adam, adamw, sgd, adamax and radam are ``torch.optim``'s, which compute
optax's rules.  The others are written here as ``torch.optim.Optimizer``
subclasses after optax 0.2.6's update rules with the defaults the JAX
registry calls them with (its ``optimizers.py:29-53``): rmsprop
(``scale_by_rms``), adagrad (``scale_by_rss``), lamb, novograd, yogi, lars,
sm3, adafactor and adabelief.  lamb, novograd and lars take the weight
decay inside their rule; the others add it to the gradient first
(``add_decayed_weights`` before the rule, JAX ``optimizers.py:57-58``), and
all of it runs after the global-norm clip.  Each keeps its state in
``self.state``, so ``state_dict`` / ``load_state_dict`` resume it.

``ranger`` raises: the JAX package's ranger (``optax.lookahead`` over
radam, its ``optimizers.py:50-52``) fails at its first update, because
``lookahead`` wants ``LookaheadParams`` and the JAX Trainer passes plain
parameters, so there is no reference to port.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ..utils.profiling import span

_KNOWN = ("adam", "adamw", "sgd", "rmsprop", "adagrad", "adamax", "radam", "lamb", "novograd", "yogi",
          "lars", "sm3", "adafactor", "adabelief")
RANGER_FAULT = ("optimizer 'ranger' is not ported: the JAX package's ranger (optax.lookahead over radam) "
                "fails at its first update with \"AttributeError: 'list' object has no attribute 'fast'\" "
                "(lookahead needs LookaheadParams, and the JAX Trainer passes plain parameters), so there "
                "is no reference rule to follow")


class _OptaxRule(torch.optim.Optimizer):
    """An optax update rule over torch parameters.  ``step`` adds
    ``weight_decay * p`` to each gradient first unless the rule takes the
    decay itself (``decay_inside``), then adds the rule's ``update`` (the
    learning rate applied) to the parameter.  The state of each parameter
    is a dict of tensors and a step count."""

    decay_inside = False

    def __init__(self, params, lr: float, weight_decay: float = 0.0, **hyper):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, **hyper))

    def init_state(self, p: torch.Tensor, group: dict) -> dict:
        raise NotImplementedError

    def update(self, p: torch.Tensor, g: torch.Tensor, state: dict, group: dict) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd and not self.decay_inside:
                    g = g + wd * p
                state = self.state[p]
                if not state:
                    state.update(self.init_state(p, group))
                p.add_(self.update(p, g, state, group))


def _moment(g, m, decay: float, order: int = 1):
    """optax's ``update_moment``: (1 - decay) * g**order + decay * m."""
    return (1 - decay) * (g.square() if order == 2 else g) + decay * m


def _debias(m, decay: float, count: int):
    """optax's ``bias_correction``: m / (1 - decay**count), the divisor in
    f32 as optax computes it."""
    return m / float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _trust_ratio(p, u, coefficient: float = 1.0, eps: float = 0.0):
    """optax's ``scale_by_trust_ratio`` factor for one parameter:
    coefficient * |p| / (|u| + eps), or 1 where either norm is 0."""
    pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
    ratio = coefficient * pn / (un + eps)
    return torch.where((pn == 0) | (un == 0), torch.ones((), dtype=p.dtype, device=p.device), ratio)


class RMSprop(_OptaxRule):
    """optax ``rmsprop`` (``scale_by_rms``): nu = decay nu + (1 - decay) g^2,
    update -lr g / sqrt(nu + eps), eps inside the root, nu starting at
    ``initial_scale``."""

    def __init__(self, params, lr, weight_decay=0.0, decay=0.9, eps=1e-8, initial_scale=0.0):
        super().__init__(params, lr, weight_decay, decay=decay, eps=eps, initial_scale=initial_scale)

    def init_state(self, p, group):
        return {"nu": torch.full_like(p, group["initial_scale"])}

    def update(self, p, g, state, group):
        state["nu"] = nu = _moment(g, state["nu"], group["decay"], 2)
        return -group["lr"] * (torch.rsqrt(nu + group["eps"]) * g)


class Adagrad(_OptaxRule):
    """optax ``adagrad`` (``scale_by_rss``): the sum of squares from
    ``initial_accumulator_value``, update -lr g / sqrt(sum + eps), 0 where
    the sum is 0."""

    def __init__(self, params, lr, weight_decay=0.0, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, lr, weight_decay, initial_accumulator_value=initial_accumulator_value, eps=eps)

    def init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])}

    def update(self, p, g, state, group):
        state["sum_of_squares"] = s = g.square() + state["sum_of_squares"]
        inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros((), dtype=s.dtype, device=s.device))
        return -group["lr"] * (inv * g)


class AdaBelief(_OptaxRule):
    """optax ``adabelief`` (``scale_by_belief``): the second moment of
    g - mu, eps_root added to it every step."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps, eps_root=eps_root)

    def init_state(self, p, group):
        return {"step": 0, "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        state["mu"] = mu = _moment(g, state["mu"], b1)
        state["nu"] = nu = _moment(g - mu, state["nu"], b2, 2) + group["eps_root"]
        state["step"] = t = state["step"] + 1
        return -group["lr"] * (_debias(mu, b1, t) / (torch.sqrt(_debias(nu, b2, t)) + group["eps"]))


class Yogi(_OptaxRule):
    """optax ``yogi`` (``scale_by_yogi``): nu -= (1 - b2) sign(nu - g^2) g^2,
    both moments starting at 1e-6."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-3, initial_accumulator_value=1e-6):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps,
                         initial_accumulator_value=initial_accumulator_value)

    def init_state(self, p, group):
        v = group["initial_accumulator_value"]
        return {"step": 0, "mu": torch.full_like(p, v), "nu": torch.full_like(p, v)}

    def update(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        g2 = g.square()
        state["mu"] = mu = _moment(g, state["mu"], b1)
        state["nu"] = nu = state["nu"] - (1 - b2) * torch.sign(state["nu"] - g2) * g2
        state["step"] = t = state["step"] + 1
        return -group["lr"] * (_debias(mu, b1, t) / (torch.sqrt(_debias(nu, b2, t)) + group["eps"]))


class Lamb(_OptaxRule):
    """optax ``lamb``: Adam's direction plus weight_decay * p, scaled by
    the trust ratio |p| / |direction|."""

    decay_inside = True

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps, eps_root=eps_root)

    def init_state(self, p, group):
        return {"step": 0, "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        b1, b2 = group["b1"], group["b2"]
        state["mu"] = mu = _moment(g, state["mu"], b1)
        state["nu"] = nu = _moment(g, state["nu"], b2, 2)
        state["step"] = t = state["step"] + 1
        u = _debias(mu, b1, t) / (torch.sqrt(_debias(nu, b2, t) + group["eps_root"]) + group["eps"])
        u = u + group["weight_decay"] * p
        return -group["lr"] * (u * _trust_ratio(p, u))


class NovoGrad(_OptaxRule):
    """optax ``novograd`` (``scale_by_novograd``): a second moment per
    parameter tensor (of |g|^2), the first moment of g / sqrt(nu) +
    weight_decay * p without (1 - b1), both started from the first
    step's values."""

    decay_inside = True

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0):
        super().__init__(params, lr, weight_decay, b1=b1, b2=b2, eps=eps, eps_root=eps_root)

    def init_state(self, p, group):
        return {"step": 0, "mu": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype, device=p.device)}

    def update(self, p, g, state, group):
        state["step"] = t = state["step"] + 1
        norm2 = torch.linalg.vector_norm(g) ** 2
        nu = norm2 if t == 1 else _moment(norm2, state["nu"], group["b2"])
        u = g / (torch.sqrt(nu + group["eps_root"]) + group["eps"]) + group["weight_decay"] * p
        state["nu"], state["mu"] = nu, u if t == 1 else group["b1"] * state["mu"] + u
        return -group["lr"] * state["mu"]


class Lars(_OptaxRule):
    """optax ``lars``: g + weight_decay * p scaled by the trust ratio
    0.001 |p| / |.|, then the learning rate, then momentum (a trace of the
    scaled updates)."""

    decay_inside = True

    def __init__(self, params, lr, weight_decay=0.0, trust_coefficient=0.001, eps=0.0, momentum=0.9):
        super().__init__(params, lr, weight_decay, trust_coefficient=trust_coefficient, eps=eps, momentum=momentum)

    def init_state(self, p, group):
        return {"trace": torch.zeros_like(p)}

    def update(self, p, g, state, group):
        u = g + group["weight_decay"] * p
        u = u * _trust_ratio(p, u, group["trust_coefficient"], group["eps"])
        state["trace"] = tr = -group["lr"] * u + group["momentum"] * state["trace"]
        return tr


class SM3(_OptaxRule):
    """optax ``sm3`` (``scale_by_sm3``, b2 = 1): one accumulator vector per
    dimension of a parameter, the elementwise accumulator their min plus
    g^2, and momentum over g / sqrt(accumulator)."""

    def __init__(self, params, lr, weight_decay=0.0, momentum=0.9, eps=1e-8):
        super().__init__(params, lr, weight_decay, momentum=momentum, eps=eps)

    def init_state(self, p, group):
        if p.ndim == 0:
            raise ValueError("sm3 keeps one accumulator per dimension, and a 0-d parameter has none "
                             "(optax's scale_by_sm3 fails on one too)")
        state = {f"mu_{i}": torch.zeros(s, dtype=p.dtype, device=p.device) for i, s in enumerate(p.shape)}
        state["nu"] = torch.zeros_like(p)
        return state

    def update(self, p, g, state, group):
        nd = g.ndim
        mus = [state[f"mu_{i}"].reshape([1] * i + [g.shape[i]] + [1] * (nd - i - 1)) for i in range(nd)]
        least = mus[0]
        for m in mus[1:]:
            least = torch.minimum(least, m)
        accum = g.square() + least
        inv = torch.where(accum > 0, torch.rsqrt(accum + group["eps"]),
                          torch.zeros((), dtype=accum.dtype, device=accum.device))
        state["nu"] = nu = _moment(g * inv, state["nu"], group["momentum"])
        for i in range(nd):
            other = [d for d in range(nd) if d != i]
            state[f"mu_{i}"] = accum.amax(dim=other) if other else accum
        return -group["lr"] * nu


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's choice of the two dimensions adafactor factors (the two
    largest, by numpy's argsort), or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(_OptaxRule):
    """optax ``adafactor`` with its defaults: factored second moments
    (``scale_by_factored_rms``: a row and a column accumulator for a
    parameter whose two largest dimensions are >= 128, else a full one;
    decay 1 - (t + 1)^-0.8), each block's update clipped to RMS 1, times the
    learning rate and the parameter's RMS (at least 1e-3)."""

    def __init__(self, params, lr, weight_decay=0.0, min_dim_size_to_factor=128, decay_rate=0.8, eps=1e-30,
                 clipping_threshold=1.0, min_param_scale=1e-3):
        super().__init__(params, lr, weight_decay, min_dim_size_to_factor=min_dim_size_to_factor,
                         decay_rate=decay_rate, eps=eps, clipping_threshold=clipping_threshold,
                         min_param_scale=min_param_scale)

    def init_state(self, p, group):
        dims = _factored_dims(p.shape, group["min_dim_size_to_factor"])
        if dims is None:
            return {"step": 0, "v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"step": 0, "v_row": p.new_zeros(np.delete(p.shape, d0).tolist()),
                "v_col": p.new_zeros(np.delete(p.shape, d1).tolist())}

    def update(self, p, g, state, group):
        t = state["step"]
        decay = float(np.float32(1) - np.float32(t + 1) ** np.float32(-group["decay_rate"]))
        g2 = g.square() + group["eps"]
        dims = _factored_dims(p.shape, group["min_dim_size_to_factor"])
        if dims is None:
            state["v"] = v = decay * state["v"] + (1.0 - decay) * g2
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            state["v_row"] = v_row = decay * state["v_row"] + (1.0 - decay) * g2.mean(dim=d0)
            state["v_col"] = v_col = decay * state["v_col"] + (1.0 - decay) * g2.mean(dim=d1)
            row_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
            u = g * (v_row / row_mean).pow(-0.5).unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
        state["step"] = t + 1
        u = u / torch.clamp(torch.sqrt(u.square().mean()) / group["clipping_threshold"], min=1.0)
        u = group["lr"] * u
        u = u * torch.clamp(torch.sqrt(p.square().mean()), min=group["min_param_scale"])
        return -u


_RULES = {"rmsprop": RMSprop, "adagrad": Adagrad, "adabelief": AdaBelief, "yogi": Yogi, "lamb": Lamb,
          "novograd": NovoGrad, "lars": Lars, "sm3": SM3, "adafactor": Adafactor}


def _base(name: str, params, lr: float, weight_decay: float, **kw) -> torch.optim.Optimizer:
    name = name.lower()
    wd = weight_decay or 0.0
    if name in ("adam", "adamw"):
        # decoupled weight decay whenever there is one, as optax.adamw
        if name == "adamw" or wd:
            return torch.optim.AdamW(params, lr=lr, weight_decay=wd, **kw)
        return torch.optim.Adam(params, lr=lr, **kw)
    classes = {"sgd": torch.optim.SGD, "adamax": torch.optim.Adamax, "radam": torch.optim.RAdam, **_RULES}
    if name in classes:
        return classes[name](params, lr=lr, weight_decay=wd, **kw)
    if name == "ranger":
        raise NotImplementedError(RANGER_FAULT)
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
        with span("optim.step"):
            with span("optim.clip"):
                self.clip_grads()
            with span("optim.update"):
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
