"""Conv-TasNet (counterpart of ``audio_only_speech_separation_tpu/models/convtasnet.py``;
reference look2hear/models/convtasnet.py:148-219).

Free-filter encoder (stride L//4), R stacks of X dilated depthwise
Conv1D blocks, a 1x1 mask head, and the synthesis filterbank.  Quirks kept:
the pad uses stride L//2 while the filterbank strides L//4, and the output
crop is ``[win - pad_stride : -(rest + win - pad_stride)]``.

``fused_inference_forward`` is the serving path: plain framing and
overlap-add around the whole separator in one CUDA kernel sequence
(``ops/kernels/convtasnet_block.py``).  ``make_kernel_train_apply`` is the
bf16 training forward: plain encoder, bottleneck, mask and decoder ops
around the TCN chain's forward and backward kernels
(``ops/kernels/convtasnet_backward.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.activations import PReLU
from ..ops.conv import ConvDecoder, ConvEncoder, frame_signal, overlap_add
from ..ops.kernels.convtasnet_backward import tcn_chain
from ..ops.kernels.convtasnet_block import (
    _dot,
    block_kernel_ok,
    fused_convtasnet_separator,
    pack_convtasnet_full_params,
    pack_convtasnet_full_params_differentiable,
)
from ..ops.norms import CumulativeLayerNorm, GlobalLayerNorm
from . import register_model
from .base import BaseModel, normalize_input, restore_output


class Conv1DBlock(nn.Module):
    """1x1 -> PReLU+norm -> dilated depthwise -> PReLU+norm -> 1x1, residual
    (reference convtasnet.py:28-69).  ``norm_type="cLN"`` makes it causal."""

    def __init__(self, in_channels, out_channels, kernel_size=3, dilation=1,
                 norm_type="gLN", device=None):
        super().__init__()
        self.causal = norm_type == "cLN"
        span = dilation * (kernel_size - 1)
        self.pad = span if self.causal else span // 2
        norm_cls = CumulativeLayerNorm if self.causal else GlobalLayerNorm
        self.conv1x1 = nn.Conv1d(in_channels, out_channels, 1, device=device)
        self.prelu1 = PReLU(device=device)
        self.norm1 = norm_cls(out_channels, device=device)
        self.dwconv = nn.Conv1d(
            out_channels, out_channels, kernel_size, dilation=dilation,
            padding=self.pad, groups=out_channels, device=device,
        )
        self.prelu2 = PReLU(device=device)
        self.norm2 = norm_cls(out_channels, device=device)
        self.sconv = nn.Conv1d(out_channels, in_channels, 1, device=device)

    def forward(self, x):
        w = self.norm1(self.prelu1(self.conv1x1(x)))
        w = self.dwconv(w)
        if self.causal:
            w = w[:, :, : -self.pad]
        w = self.norm2(self.prelu2(w))
        return x + self.sconv(w)


def _pads(model, T: int):
    """(win, pad_stride, fb_stride, rest) of the reference's padding."""
    win, pad_stride = model.L, model.L // 2
    rest = win - (pad_stride + T % win) % win
    return win, pad_stride, model.L // 4, rest


def _pad_wave(x, win, pad_stride, rest):
    if rest > 0:
        x = nn.functional.pad(x, (0, rest))
    return nn.functional.pad(x, (win - pad_stride, win - pad_stride))


@register_model
class ConvTasNet(BaseModel):
    """Channels-first ConvTasNet with look2hear ``state_dict`` names.

    ``generator`` seeds the initial weights (none: seed 0); ``device``
    places them."""

    def __init__(self, N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN",
                 num_spks=2, activate="relu", causal=False, sample_rate=16000,
                 n_src=2, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if activate not in ("relu", "sigmoid", "softmax"):
            raise RuntimeError(f"Unsupported non-linear function: {activate}")
        self.N, self.L, self.B, self.H, self.P, self.X, self.R = N, L, B, H, P, X, R
        self.norm, self.num_spks, self.activate, self.causal = norm, num_spks, activate, causal
        self.sample_rate, self.n_src = sample_rate, n_src  # n_src: config parity only
        fb_stride = L // 4
        self.encoder = ConvEncoder(N, L, fb_stride, device=device)
        bn_norm = CumulativeLayerNorm if causal else GlobalLayerNorm
        self.bottleneck = nn.Sequential(bn_norm(N, device=device), nn.Conv1d(N, B, 1, device=device))
        block_norm = norm if not causal else "cLN"
        self.separation = nn.ModuleDict({"sep": nn.ModuleList([
            nn.ModuleDict({"tcn": nn.ModuleList([
                Conv1DBlock(B, H, P, dilation=2**i, norm_type=block_norm, device=device)
                for i in range(X)
            ])})
            for _ in range(R)
        ])})
        self.mask = nn.Conv1d(B, N * num_spks, 1, device=device)
        self.decoder = ConvDecoder(N, L, fb_stride, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Seeded init: torch's default Conv1d bounds, xavier filterbanks,
        unit norms, PReLU 0.25."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.encoder.reset_parameters(g)
        self.decoder.reset_parameters(g)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv1d):
                    bound = 1.0 / math.sqrt(m.in_channels // m.groups * m.kernel_size[0])
                    for t in (m.weight, m.bias):
                        t.copy_((torch.rand(t.shape, generator=g) * 2 - 1) * bound)
                elif isinstance(m, (GlobalLayerNorm, CumulativeLayerNorm)):
                    m.weight.fill_(1.0)
                    m.bias.fill_(0.0)
                elif isinstance(m, PReLU):
                    m.weight.fill_(0.25)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x, was_one_d = normalize_input(wav)
        Bsz, T = x.shape
        win, pad_stride, _, rest = _pads(self, T)
        x = _pad_wave(x, win, pad_stride, rest)
        enc = self.encoder(x)  # [B, N, T']
        times = enc.shape[-1]
        w = self.bottleneck(enc)
        for stack in self.separation["sep"]:
            for block in stack["tcn"]:
                w = block(w)
        m = self.mask(w)
        if self.activate == "relu":
            m = torch.relu(m)
        elif self.activate == "sigmoid":
            m = torch.sigmoid(m)
        else:
            m = torch.softmax(m, dim=1)
        d = enc[:, None] * m.reshape(Bsz, self.num_spks, self.N, times)
        s = self.decoder(d.reshape(Bsz * self.num_spks, self.N, times))
        s = s[:, win - pad_stride : s.shape[-1] - (rest + win - pad_stride)]
        return restore_output(s.reshape(Bsz, self.num_spks, -1), was_one_d)


def _fused_shape_ok(model: ConvTasNet) -> bool:
    """Envelope of the whole-separator kernel: N == H (the bottleneck rides
    the block weight stream as pseudo-block 0), the block body's own
    (``block_kernel_ok``: H a multiple of 128 up to 640, a 128-channel
    bottleneck, 16-sample filters), 3-tap depthwise, non-causal gLN, relu
    or sigmoid mask."""
    return (
        model.N == model.H
        and block_kernel_ok(model.H, model.B, model.L)
        and model.P == 3
        and not model.causal
        and model.norm == "gLN"
        and model.activate in ("relu", "sigmoid")
    )


def _require_fused_shape(model: ConvTasNet) -> None:
    if model.activate not in ("relu", "sigmoid"):
        raise ValueError(f"mask activation {model.activate!r} is outside the fused kernels' "
                         "envelope (relu or sigmoid)")
    if not _fused_shape_ok(model):
        raise ValueError(
            "config is outside the fused kernels' envelope "
            "(needs N == H, H % 128 == 0, H <= 640, B == 128, L == 16, P == 3, "
            "non-causal gLN, relu|sigmoid mask)"
        )


def fused_forward_eligible(model: ConvTasNet, device: torch.device | str) -> bool:
    """Whether the whole-separator CUDA kernel serves this config on ``device``."""
    return torch.device(device).type == "cuda" and _fused_shape_ok(model)


def inference_frames(model: ConvTasNet, x: torch.Tensor) -> torch.Tensor:
    """[B, T] wave -> the contiguous bf16 frames [B, T', L] that the fused
    path hands its separator: cast to bf16 first, then padded and framed."""
    win, pad_stride, fb_stride, rest = _pads(model, x.shape[1])
    x = _pad_wave(x.to(torch.bfloat16), win, pad_stride, rest)
    return frame_signal(x, win, fb_stride).contiguous()


def fused_inference_forward(model: ConvTasNet, wav: torch.Tensor, packed=None,
                            separator=fused_convtasnet_separator) -> torch.Tensor:
    """bf16 inference forward through the whole-separator kernel.

    Plain ops cast the wave to bf16, pad and frame it, and overlap-add the
    kernel's decoder frames.  On a CUDA tensor the separator is the CUDA
    kernel; on a CPU tensor it is its plain version.  Raises for a config
    outside the kernel's envelope (use the module itself there).

    ``packed`` (from ``pack_convtasnet_full_params``, on ``wav``'s device)
    can be computed once and reused.  ``separator`` replaces
    ``fused_convtasnet_separator`` (same arguments); passing
    ``convtasnet_separator_reference`` runs this path without the kernel on
    any device, which is what the kernel is checked against."""
    _require_fused_shape(model)
    if packed is None:
        packed = pack_convtasnet_full_params(
            model.state_dict(), model.R, model.X, model.num_spks, device=wav.device
        )
    *weights, dils = packed
    x, was_one_d = normalize_input(wav)
    Bsz, T = x.shape
    win, pad_stride, fb_stride, rest = _pads(model, T)
    frames = inference_frames(model, x)
    times = frames.shape[1]
    dec = separator(
        frames, *weights, dilations=dils, nspk=model.num_spks,
        sigmoid=model.activate == "sigmoid",
    )  # [B, spk, T', win]
    s = overlap_add(dec.reshape(Bsz * model.num_spks, times, win), fb_stride)
    s = s[:, win - pad_stride : s.shape[-1] - (rest + win - pad_stride)]
    return restore_output(s.reshape(Bsz, model.num_spks, -1), was_one_d)


def make_kernel_train_apply(model: ConvTasNet, chain=tcn_chain):
    """bf16 training forward through the TCN chain's kernels (counterpart of
    the JAX package's ``make_kernel_train_apply``).

    Returns ``apply_fn(params, wav) -> [B, nspk, T] bf16``, where ``params``
    is ``{state_dict name: tensor}`` (the trainer passes bf16 casts of the
    f32 master parameters) and ``wav`` is bf16.  The weights are packed per
    call by differentiable f32 folds; the encoder, the bottleneck gLN + 1x1
    (delayed form), the mask head and the decoder are plain ops with bf16
    operands and f32 products; the R*X blocks run as ``chain``, by default
    ``tcn_chain`` (forward and backward kernels on CUDA tensors, their
    plain versions on CPU tensors).  ``chain=tcn_chain_reference`` runs the
    plain chain under autograd, which is what the kernels are checked
    against.

    Raises for a config outside the kernels' envelope (an activation other
    than relu or sigmoid, causal or cLN configs, ...): use the module
    there."""
    _require_fused_shape(model)
    nspk = model.num_spks
    bf = torch.bfloat16

    def apply_fn(params, wav):
        we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, dils = (
            pack_convtasnet_full_params_differentiable(params, model.R, model.X, nspk))
        x, was_one_d = normalize_input(wav)
        Bsz, T = x.shape
        win, pad_stride, fb_stride, rest = _pads(model, T)
        frames = frame_signal(_pad_wave(x.to(bf), win, pad_stride, rest), win, fb_stride)
        times = frames.shape[1]
        enc = _dot(frames, we).to(bf)  # [B, T', N]

        # bottleneck gLN + 1x1, delayed form: rstd * (enc @ g*W) + shift
        ef = enc.float()
        mean = ef.mean(dim=(1, 2), keepdim=True)
        var = torch.clamp(ef.square().mean(dim=(1, 2), keepdim=True) - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + 1e-8)
        y0 = (rstd * _dot(enc, wsgs[0]) + (cs[0, 0] - mean * rstd * cs[0, 1])).to(bf)

        y = chain(y0.contiguous(), w1s[1:], wsgs[1:], vecs[1:], cs[1:], alphas[1:], dils)

        m = _dot(y, wm) + bm[0]
        m = torch.relu(m) if model.activate == "relu" else torch.sigmoid(m)
        dsrc = m.to(bf).reshape(Bsz, times, nspk, model.N) * enc[:, :, None, :]
        dsrc = dsrc.transpose(1, 2).reshape(Bsz * nspk, times, model.N)
        dec = _dot(dsrc, wd).to(bf)
        s = overlap_add(dec, fb_stride)
        s = s[:, win - pad_stride : s.shape[-1] - (rest + win - pad_stride)]
        return restore_output(s.reshape(Bsz, nspk, -1), was_one_d)

    return apply_fn
