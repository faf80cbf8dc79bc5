"""Conv-TasNet (Luo and Mesgarani, arXiv:1809.07454) as look2hear's
``ConvTasNet`` runs it, in plain float32 PyTorch from a ``state_dict``.

Learned encoder (N filters of length L, stride L/4, no bias), gLN and a
1x1 bottleneck to B channels, R repeats of X blocks (1x1 to H, PReLU,
gLN, depthwise conv of P taps at dilation 2^i, PReLU, gLN, 1x1 back to B,
residual; no skip path), a 1x1 mask head to N x speakers with relu, the
mask on the encoding, and the transposed-conv decoder.  look2hear's
padding: the wave is right-padded by ``rest`` and then by L - L/2 on both
sides, and the output cropped by the same amounts.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import Quant, conv1d, conv_transpose1d, gln, init_range, prelu

EPS = 1e-8


def param_shapes(cfg) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every parameter, its seeded draw
    uniform in offset +- scale (``common.init_range``)."""
    leaves = _leaves(cfg)
    shapes = {n: s for n, s, _ in leaves}
    return [(n, s, *init_range(k, s, fan_in(n, shapes) if k == "conv" else 1)) for n, s, k in leaves]


def _leaves(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter."""
    N, L, B, H, P = cfg["N"], cfg["L"], cfg["B"], cfg["H"], cfg["P"]
    spk = cfg["num_spks"]
    out = [("encoder._filters", (N, 1, L), "filter"),
           ("bottleneck.0.weight", (N,), "norm_w"), ("bottleneck.0.bias", (N,), "norm_b"),
           ("bottleneck.1.weight", (B, N, 1), "conv"), ("bottleneck.1.bias", (B,), "conv")]
    for r in range(cfg["R"]):
        for i in range(cfg["X"]):
            p = f"separation.sep.{r}.tcn.{i}."
            out += [(p + "conv1x1.weight", (H, B, 1), "conv"), (p + "conv1x1.bias", (H,), "conv"),
                    (p + "prelu1.weight", (1,), "prelu"),
                    (p + "norm1.weight", (H,), "norm_w"), (p + "norm1.bias", (H,), "norm_b"),
                    (p + "dwconv.weight", (H, 1, P), "conv"), (p + "dwconv.bias", (H,), "conv"),
                    (p + "prelu2.weight", (1,), "prelu"),
                    (p + "norm2.weight", (H,), "norm_w"), (p + "norm2.bias", (H,), "norm_b"),
                    (p + "sconv.weight", (B, H, 1), "conv"), (p + "sconv.bias", (B,), "conv")]
    out += [("mask.weight", (N * spk, B, 1), "conv"), ("mask.bias", (N * spk,), "conv"),
            ("decoder._filters", (N, 1, L), "filter")]
    return out


def fan_in(name: str, shapes: Dict[str, tuple]) -> int:
    """The fan-in that sets a conv leaf's init bound: its weight's
    in-channels x taps (a bias takes its weight's)."""
    w = shapes[name.rsplit(".", 1)[0] + ".weight"]
    return w[1] * w[2]


def forward(sd: Dict[str, torch.Tensor], wav: torch.Tensor, cfg, q: Quant = None) -> torch.Tensor:
    """[batch, T] -> [batch, speakers, T] in float32."""
    N, L, spk = cfg["N"], cfg["L"], cfg["num_spks"]
    x = wav.float()
    nb, T = x.shape
    pad_stride, stride = L // 2, L // 4
    rest = L - (pad_stride + T % L) % L
    x = F.pad(x, (L - pad_stride, rest + L - pad_stride))
    enc = conv1d(x[:, None], sd["encoder._filters"], q=q, stride=stride)  # [batch, N, T']
    w = gln(enc, sd["bottleneck.0.weight"], sd["bottleneck.0.bias"], EPS)
    w = conv1d(w, sd["bottleneck.1.weight"], sd["bottleneck.1.bias"], q=q)
    for r in range(cfg["R"]):
        for i in range(cfg["X"]):
            p = f"separation.sep.{r}.tcn.{i}."
            d = 2 ** i
            h = conv1d(w, sd[p + "conv1x1.weight"], sd[p + "conv1x1.bias"], q=q)
            h = gln(prelu(h, sd[p + "prelu1.weight"]), sd[p + "norm1.weight"], sd[p + "norm1.bias"], EPS)
            h = conv1d(h, sd[p + "dwconv.weight"], sd[p + "dwconv.bias"], q=q, dilation=d,
                       padding=d * (cfg["P"] - 1) // 2, groups=h.shape[1])
            h = gln(prelu(h, sd[p + "prelu2.weight"]), sd[p + "norm2.weight"], sd[p + "norm2.bias"], EPS)
            w = w + conv1d(h, sd[p + "sconv.weight"], sd[p + "sconv.bias"], q=q)
    m = torch.relu(conv1d(w, sd["mask.weight"], sd["mask.bias"], q=q))
    masked = enc[:, None] * m.reshape(nb, spk, N, -1)
    s = conv_transpose1d(masked.reshape(nb * spk, N, -1), sd["decoder._filters"], q=q, stride=stride)[:, 0]
    s = s[:, L - pad_stride: s.shape[-1] - (rest + L - pad_stride)]
    return s.reshape(nb, spk, -1)


def frames(cfg, T: int) -> int:
    """Encoder frames of a T-sample wave."""
    L = cfg["L"]
    rest = L - (L // 2 + T % L) % L
    return (T + rest + 2 * (L - L // 2) - L) // (L // 4) + 1


def forward_flops(cfg, T: int) -> int:
    """Products' FLOPs of one forward of a T-sample wave (2 a multiply-add):
    encoder, bottleneck, per block two 1x1s and the depthwise taps, mask
    head and decoder; norms and elementwise operations not counted."""
    N, L, B, H, P, spk = cfg["N"], cfg["L"], cfg["B"], cfg["H"], cfg["P"], cfg["num_spks"]
    nb = cfg["R"] * cfg["X"]
    per_frame = 2 * L * N + 2 * N * B + nb * (2 * 2 * B * H + 2 * P * H) + 2 * B * spk * N + 2 * spk * N * L
    return frames(cfg, T) * per_frame
