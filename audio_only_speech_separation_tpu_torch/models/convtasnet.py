"""Conv-TasNet (counterpart of ``audio_only_speech_separation_tpu/models/convtasnet.py``;
reference look2hear/models/convtasnet.py:148-219).

Free-filter encoder (stride L//4), R stacks of X dilated depthwise
Conv1D blocks, a 1x1 mask head, and the synthesis filterbank.  Quirks kept:
the pad uses stride L//2 while the filterbank strides L//4, and the output
crop is ``[win - pad_stride : -(rest + win - pad_stride)]``.

``channels_last=True`` runs the same math on [B, T', C] with the same
``state_dict`` (the JAX package's training-layout form; non-causal gLN
only).

``fused_inference_forward`` is the serving path: plain framing and
overlap-add around the whole separator in one CUDA kernel sequence
(``ops/kernels/convtasnet_block.py``).  The training forms, each
``apply_fn(params, wav)`` on bf16 casts of the parameters:

- ``make_kernel_train_apply``: plain encoder, bottleneck, mask and decoder
  ops around the TCN chain's forward and backward kernels
  (``ops/kernels/convtasnet_backward.py``);
- ``make_delayed_train_apply``: the kernels' delayed-norm algebra as plain
  differentiable ops (gLN-1 folded into the depthwise taps, gLN-2 carried
  through the following 1x1);
- ``make_fused_train_apply``: the whole-separator kernel as the primal,
  the backward recomputed through the plain bf16 module.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.activations import PReLU
from ..ops.conv import (
    ConvDecoder,
    ConvEncoder,
    conv1d_channels_last,
    depthwise_conv_channels_last,
    frame_signal,
    overlap_add,
)
from ..ops.kernels.convtasnet_backward import tcn_chain
from ..ops.kernels.convtasnet_block import (
    _B1,
    _BT1,
    _DW0,
    _DW1,
    _DW2,
    _DWB,
    _G1,
    _dot,
    _prelu,
    _stats,
    block_kernel_ok,
    fused_convtasnet_separator,
    pack_convtasnet_full_params,
    pack_convtasnet_full_params_differentiable,
)
from ..ops.norms import CumulativeLayerNorm, GlobalLayerNorm
from . import register_model
from .base import BaseModel, normalize_input, restore_output


def _norm(causal: bool, channels: int, channels_last: bool, device):
    if causal:
        if channels_last:
            raise ValueError("channels_last serves the non-causal gLN form only (cLN has no channels-last form)")
        return CumulativeLayerNorm(channels, device=device)
    return GlobalLayerNorm(channels, channels_last=channels_last, device=device)


class Conv1DBlock(nn.Module):
    """1x1 -> PReLU+norm -> dilated depthwise -> PReLU+norm -> 1x1, residual
    (reference convtasnet.py:28-69).  ``norm_type="cLN"`` makes it causal.
    ``channels_last=True`` takes and returns [B, T, C] with the same
    parameters (non-causal gLN only)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, dilation=1,
                 norm_type="gLN", channels_last=False, device=None):
        super().__init__()
        self.causal = norm_type == "cLN"
        self.channels_last = channels_last
        span = dilation * (kernel_size - 1)
        self.pad = span if self.causal else span // 2
        self.conv1x1 = nn.Conv1d(in_channels, out_channels, 1, device=device)
        self.prelu1 = PReLU(device=device)
        self.norm1 = _norm(self.causal, out_channels, channels_last, device)
        self.dwconv = nn.Conv1d(
            out_channels, out_channels, kernel_size, dilation=dilation,
            padding=self.pad, groups=out_channels, device=device,
        )
        self.prelu2 = PReLU(device=device)
        self.norm2 = _norm(self.causal, out_channels, channels_last, device)
        self.sconv = nn.Conv1d(out_channels, in_channels, 1, device=device)

    def forward(self, x):
        if self.channels_last:
            w = self.norm1(self.prelu1(conv1d_channels_last(self.conv1x1, x)))
            w = self.norm2(self.prelu2(depthwise_conv_channels_last(self.dwconv, w)))
            return x + conv1d_channels_last(self.sconv, w)
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
    """ConvTasNet with look2hear ``state_dict`` names, channels-first, or
    with ``channels_last`` on [B, T', C] throughout (same ``state_dict``;
    non-causal gLN only, as in the JAX package).

    ``generator`` seeds the initial weights (none: seed 0); ``device``
    places them."""

    def __init__(self, N=512, L=16, B=128, H=512, P=3, X=8, R=3, norm="gLN",
                 num_spks=2, activate="relu", causal=False, sample_rate=16000,
                 n_src=2, channels_last=False, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if activate not in ("relu", "sigmoid", "softmax"):
            raise RuntimeError(f"Unsupported non-linear function: {activate}")
        if channels_last and (causal or norm != "gLN"):
            raise ValueError("channels_last serves the non-causal gLN configs only")
        self.channels_last = channels_last
        self.N, self.L, self.B, self.H, self.P, self.X, self.R = N, L, B, H, P, X, R
        self.norm, self.num_spks, self.activate, self.causal = norm, num_spks, activate, causal
        self.sample_rate, self.n_src = sample_rate, n_src  # n_src: config parity only
        fb_stride = L // 4
        self.encoder = ConvEncoder(N, L, fb_stride, device=device)
        self.bottleneck = nn.Sequential(_norm(causal, N, channels_last, device),
                                        nn.Conv1d(N, B, 1, device=device))
        block_norm = norm if not causal else "cLN"
        self.separation = nn.ModuleDict({"sep": nn.ModuleList([
            nn.ModuleDict({"tcn": nn.ModuleList([
                Conv1DBlock(B, H, P, dilation=2**i, norm_type=block_norm, channels_last=channels_last,
                            device=device)
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
        if self.channels_last:
            return restore_output(self._forward_channels_last(x, Bsz, win, pad_stride, rest), was_one_d)
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

    def _forward_channels_last(self, x, Bsz: int, win: int, pad_stride: int, rest: int):
        """The separator on [B, T', C] from the padded wave: the JAX
        package's ``channels_last`` branch (softmax over the last axis, which
        is axis 1 of the channels-first form)."""
        frames = frame_signal(x, win, self.L // 4)
        enc = torch.matmul(frames, self.encoder._filters[:, 0, :].to(x.dtype).t())  # [B, T', N]
        times = enc.shape[1]
        w = conv1d_channels_last(self.bottleneck[1], self.bottleneck[0](enc))
        for stack in self.separation["sep"]:
            for block in stack["tcn"]:
                w = block(w)
        m = conv1d_channels_last(self.mask, w)  # [B, T', spk * N]
        if self.activate == "relu":
            m = torch.relu(m)
        elif self.activate == "sigmoid":
            m = torch.sigmoid(m)
        else:
            m = torch.softmax(m, dim=-1)
        d = (m.reshape(Bsz, times, self.num_spks, self.N) * enc[:, :, None, :]).transpose(1, 2)
        dec = torch.matmul(d.reshape(Bsz * self.num_spks, times, self.N),
                           self.decoder._filters[:, 0, :].to(d.dtype))
        s = overlap_add(dec, self.L // 4)
        s = s[:, win - pad_stride : s.shape[-1] - (rest + win - pad_stride)]
        return s.reshape(Bsz, self.num_spks, -1)


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


def _packed_train_apply(model: ConvTasNet, chain, carry=torch.bfloat16):
    """``apply_fn(params, wav)``: the encoder, the bottleneck gLN + 1x1 in
    the delayed form, ``chain`` over the R*X blocks, the mask head and the
    decoder, on weights packed per call by differentiable folds (gradients
    reach ``params`` through them).  bf16 operands with f32 products;
    ``carry`` is the dtype of y between the blocks."""
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
        mean, rstd = _stats(enc.float())
        y0 = (rstd * _dot(enc, wsgs[0]) + (cs[0, 0] - mean * rstd * cs[0, 1])).to(carry)

        y = chain(y0.contiguous(), w1s[1:], wsgs[1:], vecs[1:], cs[1:], alphas[1:], dils)

        m = _dot(y.to(bf), wm) + bm[0]
        if model.activate == "relu":
            m = torch.relu(m)
        elif model.activate == "sigmoid":
            m = torch.sigmoid(m)
        else:
            m = torch.softmax(m, dim=-1)
        dsrc = m.to(bf).reshape(Bsz, times, nspk, model.N) * enc[:, :, None, :]
        dsrc = dsrc.transpose(1, 2).reshape(Bsz * nspk, times, model.N)
        dec = _dot(dsrc, wd).to(bf)
        s = overlap_add(dec, fb_stride)
        s = s[:, win - pad_stride : s.shape[-1] - (rest + win - pad_stride)]
        return restore_output(s.reshape(Bsz, nspk, -1), was_one_d)

    return apply_fn


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
    return _packed_train_apply(model, chain)


def tcn_chain_delayed(y, w1s, wsgs, vecs, cs, alphas, dilations):
    """The TCN chain in the JAX package's delayed-norm algebra
    (``make_delayed_train_apply``'s loop), as plain differentiable ops:
    y [B, T, C] (f32 between the blocks, rounded to bf16 as each block's
    matmul operand) -> f32.  Per block h = PReLU(y @ W1 + b1) in bf16; gLN-1
    folded into the depthwise taps (bf16 tap chain, f32 coefficients cast
    once) with its shift taken off the taps that read the zero padding, as
    the reference pads after the norm; gLN-2 carried through the 1x1 as
    ``rstd2 * (v @ g2*Ws) + c0 - mean2*rstd2*c1``.  Statistics in f32."""
    bf = torch.bfloat16
    T = y.shape[1]
    row = torch.arange(T, device=y.device)[None, :, None]
    zero = torch.zeros((), dtype=bf, device=y.device)
    for b, d in enumerate(dilations):
        vec = vecs[b]
        h = _prelu(_dot(y.to(bf), w1s[b]) + vec[_B1], alphas[b, 0]).to(bf)
        mean1, rstd1 = _stats(h.float())
        sc1 = vec[_G1] * rstd1  # [B, 1, H] f32
        sh1 = vec[_BT1] - mean1 * sc1
        c0, c1, c2 = ((vec[k] * sc1).to(bf) for k in (_DW0, _DW1, _DW2))
        cb = (vec[_DWB] + (vec[_DW0] + vec[_DW1] + vec[_DW2]) * sh1).to(bf)
        down = torch.nn.functional.pad(h, (0, 0, d, 0))[:, :T]  # h[t-d]
        up = torch.nn.functional.pad(h, (0, 0, 0, d))[:, d:]  # h[t+d]
        t = down * c0 + h * c1 + up * c2 + cb
        t = t - torch.where(row < d, (vec[_DW0] * sh1).to(bf), zero)
        t = t - torch.where(row >= T - d, (vec[_DW2] * sh1).to(bf), zero)
        v = _prelu(t, alphas[b, 1].to(bf))
        mean2, rstd2 = _stats(v.float())
        y = y + rstd2 * _dot(v, wsgs[b]) + (cs[b, 0] - mean2 * rstd2 * cs[b, 1])
    return y


def make_delayed_train_apply(model: ConvTasNet):
    """bf16 training forward in the kernels' delayed-norm algebra, as plain
    differentiable ops (counterpart of the JAX package's
    ``make_delayed_train_apply``): ``apply_fn(params, wav)`` as
    ``make_kernel_train_apply``'s, with ``tcn_chain_delayed`` for the chain
    (y carried in f32 between the blocks, as there) and any of the three
    mask activations.  Autograd differentiates it through
    ``pack_convtasnet_full_params_differentiable`` to ``params``.

    Raises for causal or cLN configs, a depthwise kernel other than 3, or
    N != H (the packed layout stacks the bottleneck as pseudo-block 0),
    where the JAX function returns None."""
    if model.causal or model.norm != "gLN" or model.P != 3 or model.N != model.H:
        raise ValueError("the delayed train form takes non-causal gLN configs with P == 3 and N == H")
    return _packed_train_apply(model, tcn_chain_delayed, carry=torch.float32)


class _FusedTrainForward(torch.autograd.Function):
    """The whole-separator kernel as the primal; the backward recomputes
    through the plain module at the same parameters and wave."""

    @staticmethod
    def forward(ctx, model, names, wav, *tensors):
        params = dict(zip(names, tensors))
        with torch.no_grad():
            packed = pack_convtasnet_full_params_differentiable(params, model.R, model.X, model.num_spks)
            out = fused_inference_forward(model, wav, packed=tuple(
                t.contiguous() if torch.is_tensor(t) else t for t in packed))
        ctx.model, ctx.names = model, names
        ctx.save_for_backward(wav, *tensors)
        return out

    @staticmethod
    def backward(ctx, grad):
        wav, *tensors = ctx.saved_tensors
        wants = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w) for t, w in zip([wav, *tensors], wants)]
            out = torch.func.functional_call(ctx.model, dict(zip(ctx.names, leaves[1:])), (leaves[0],))
            inputs = [t for t, w in zip(leaves, wants) if w]
            got = iter(torch.autograd.grad(out, inputs, grad.to(out.dtype), allow_unused=True))
        return (None, None, *(next(got) if w else None for w in wants))


def make_fused_train_apply(model: ConvTasNet):
    """bf16 training forward with the whole-separator kernel K1 as the
    primal (counterpart of the JAX package's ``make_fused_train_apply``).

    Returns ``apply_fn(params, wav) -> [B, nspk, T] bf16`` on the
    ``make_kernel_train_apply`` arguments.  The forward packs ``params``
    without gradient, per call, and runs ``fused_inference_forward``: K1 on
    a CUDA tensor, its plain version on a CPU tensor.  The backward
    recomputes through the module at the same parameters and wave
    (``torch.func.functional_call`` on them, so in their dtype: the plain
    bf16 module), as the JAX function's ``jax.vjp(model.apply)``, and
    returns the gradients of ``params`` (in their dtype, which the
    trainer's casts carry to the f32 parameters) and of ``wav``.  Only the
    parameters and the wave are saved, no activation.  ConvTasNet has no
    dropout, so the train and eval forwards are one.

    Raises for a config outside K1's envelope, where the JAX function
    returns None."""
    _require_fused_shape(model)

    def apply_fn(params, wav):
        names = tuple(params)
        return _FusedTrainForward.apply(model, names, wav, *(params[k] for k in names))

    return apply_fn
