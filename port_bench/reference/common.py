"""Pieces the references share: the product precision, gLN, PReLU, the PIT
loss over -SNR, the global-norm clip and Adam, all in plain PyTorch."""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def exact_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to 448), back in ``x``'s dtype; the gradient passes
    straight through.  The control's product precision: the step below
    bfloat16."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    rounded = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (rounded - x).detach()


def init_range(kind: str, shape: tuple, fan_in: int = 1) -> Tuple[float, float]:
    """(scale, offset) of a leaf drawn uniform in offset +- scale, by the
    kinds the references here use: "conv" (convs and linears, +-1/sqrt of
    ``fan_in``), "filter" (a filterbank, Xavier), "lstm" (+-1/sqrt(H) of a
    [4H, ...] leaf), "norm_w" (1 +- 0.1), "norm_b" (+- 0.1), "prelu"
    (0.25 +- 0.05).  A family with other leaves gives their ranges in its
    own ``param_shapes``."""
    if kind == "conv":
        return 1 / math.sqrt(fan_in), 0.0
    if kind == "filter":
        return math.sqrt(6 / (shape[0] + shape[2])), 0.0
    if kind == "lstm":
        return 1 / math.sqrt(shape[0] // 4), 0.0
    return {"norm_w": (0.1, 1.0), "norm_b": (0.1, 0.0), "prelu": (0.05, 0.25)}[kind]


def qq(q: Quant, *xs):
    """The operands of one product through ``q``."""
    return xs if q is None else tuple(q(x) for x in xs)


def conv1d(x, w, b=None, q: Quant = None, **kw):
    x, w = qq(q, x, w)
    return F.conv1d(x, w, b, **kw)


def conv_transpose1d(x, w, q: Quant = None, **kw):
    x, w = qq(q, x, w)
    return F.conv_transpose1d(x, w, **kw)


def matmul(a, b, q: Quant = None):
    a, b = qq(q, a, b)
    return torch.matmul(a, b)


def gln(x: torch.Tensor, weight, bias, eps: float, channel_axis: int = 1) -> torch.Tensor:
    """Global layer norm: per sample over every axis but the batch, then a
    per-channel affine on ``channel_axis``."""
    axes = tuple(range(1, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    shape = [1] * x.ndim
    shape[channel_axis] = -1
    return y * weight.reshape(shape) + bias.reshape(shape)


def prelu(x, slope):
    return torch.where(x >= 0, x, slope * x)


def pairwise_neg_snr(ests: torch.Tensor, targets: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """[B, n, T] x [B, n, T] -> [B, n_est, n_tgt] of -SNR in dB, both sides
    zero-mean, eps inside the ratio and the log."""
    e = ests - ests.mean(dim=-1, keepdim=True)
    t = targets - targets.mean(dim=-1, keepdim=True)
    e, t = e[:, :, None], t[:, None]
    ratio = t.square().sum(-1) / ((e - t).square().sum(-1) + eps)
    return -10.0 * torch.log10(ratio + eps)


def pit_loss(ests, targets, threshold_byloss: bool) -> torch.Tensor:
    """Mean over the batch of the best permutation's mean pairwise loss;
    with ``threshold_byloss`` the items at or below -30 dB leave the mean
    unless that leaves none."""
    pw = pairwise_neg_snr(ests, targets)
    n = pw.shape[-1]
    per_perm = torch.stack([sum(pw[:, p[j], j] for j in range(n)) / n
                            for p in itertools.permutations(range(n))], dim=1)
    best = per_perm.min(dim=1).values
    if threshold_byloss:
        keep = best > -30.0
        if bool(keep.any()):
            return best[keep].mean()
    return best.mean()


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    """The gradients scaled by min(1, max_norm / their global norm), as new
    tensors (autograd may hand one tensor to two leaves, as to an LSTM's two
    biases, so no scaling in place)."""
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    scale = max_norm / norm if norm >= max_norm else 1.0
    return {k: g * scale for k, g in grads.items()}


class Adam:
    """Adam (Kingma and Ba) on a dict of tensors, bias-corrected, eps
    outside the root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                p.sub_(self.lr * (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps))


def train_steps(forward, state_dict: Dict[str, torch.Tensor], batches: List, *, lr: float,
                grad_clip: float, threshold_byloss: bool, q: Quant = None):
    """The reference's first ``len(batches)`` training steps from
    ``state_dict``: per step the f32 forward (products through ``q``), the
    PIT -SNR loss, the gradients, the global-norm clip and Adam.  Returns
    (losses, the first step's clipped gradients, the parameters after the
    last step)."""
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in state_dict.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for mix, sources in batches:
        loss = pit_loss(forward(params, mix, q), sources, threshold_byloss)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads = clip_global_norm(grads, grad_clip)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, first, {k: p.detach() for k, p in params.items()}
