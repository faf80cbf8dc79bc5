"""TDANet, the top-down attention encoder-decoder (counterpart of
``audio_only_speech_separation_tpu/models/tdanet.py``; reference
tdanet.py:407-527), channels-last [B, T, C] throughout.

Forward: a conv encoder -> gLN and a 1x1 bottleneck -> ``num_blocks``
iterations of one weight-shared ``TDAUConvBlock`` (with ``unfold``; one
block each otherwise), the input re-injected through a depthwise gate ->
PReLU and a 1x1 to the speakers' masks -> mask x encoding -> the
transposed-conv decoder.  A block: a 1x1 up to ``in_channels``, a pyramid
of depthwise convs (stride 2 below the top), the scales average-pooled to
the deepest and summed, global attention there, a sigmoid-gated fusion of
each scale with it, and a top-down collapse.

Reference quirks kept:

- the attention's [B, T, C] input is fed to a sequence-first MHA, so it
  attends over the batch axis, batched over T: an utterance's estimate
  depends on the others in its batch;
- its residual is ``out + dropout(out)``, twice the output in eval mode;
- the collapse at i == depth - 2 fuses ``fused[i - 1]`` (not ``i + 1``)
  and never touches the deepest scale.

In bf16 on the card the attention takes the kernel K4 from inside
``ops/attention.py`` at [T_deep * 8, dh, B] (8 heads), once a block.

``fast_inference_forward`` is the JAX package's analytic-moment eval
forward: each pyramid gLN is folded into the next scale's taps (with the
zero-padding corrections at rows 0 and T_out - 1), into the pooled sum and
into the fused combine, from per-channel moments in float32; its attention
is the plain einsum form (no kernel), as the JAX package's is.

The ``state_dict`` uses look2hear's keys: ``encoder.weight``, ``ln``,
``bottleneck``, ``sm.unet.{proj_1x1, spp_dw.{k}, globalatt.{attn.{attn_in_norm,
attn, norm}, mlp.{fc1, dwconv, fc2}}, loc_glo_fus.{i}.{local_embedding,
global_embedding, global_act}, last_layer.{i}.*, res_conv}``,
``sm.concat_block.{0,1}``, ``mask_net.{0,1}`` and ``decoder.weight``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import PReLU
from ..ops.attention import MultiheadAttention, PositionalEncoding, mha_plain_form
from ..ops.conv import conv1d_channels_last, frame_signal, overlap_add
from ..ops.dropout import DropPath, Dropout
from ..ops.norms import GlobalLayerNorm
from ..ops.resample import adaptive_avg_pool1d, interpolate_nearest
from . import register_model
from .base import BaseModel, normalize_input, restore_output, seeded_init_
from .blocks.dprnn import DepthwiseGate
from .blocks.sudo import ConvNorm, ConvNormAct, DilatedConvNorm


class Mlp(nn.Module):
    """1x1 + gLN -> depthwise 5-tap conv -> ReLU -> dropout -> 1x1 + gLN ->
    dropout (tdanet.py:197-213)."""

    def __init__(self, in_features: int, hidden_size: int, drop: float = 0.1, device=None):
        super().__init__()
        self.fc1 = ConvNorm(in_features, hidden_size, 1, bias=False, device=device)
        self.dwconv = nn.Conv1d(hidden_size, hidden_size, 5, padding=2, groups=hidden_size,
                                device=device)
        self.fc2 = ConvNorm(hidden_size, in_features, 1, bias=False, device=device)
        self.drop = Dropout(drop)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(conv1d_channels_last(self.dwconv, self.fc1(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(self.hidden(x))))


class TDAAttention(nn.Module):
    """LayerNorm + sinusoidal positions -> MHA over the batch axis -> the
    doubled residual -> LayerNorm (tdanet.py:232-248), on [B, T, C]."""

    def __init__(self, channels: int, n_head: int = 8, dropout: float = 0.1, device=None):
        super().__init__()
        self.pos_enc = PositionalEncoding(channels)
        self.attn_in_norm = nn.LayerNorm(channels, eps=1e-5, device=device)
        self.attn = MultiheadAttention(channels, n_head, dropout=dropout, device=device)
        self.norm = nn.LayerNorm(channels, eps=1e-5, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pos_enc(self.attn_in_norm(x))
        out = self.attn(h.transpose(0, 1)).transpose(0, 1)  # (batch T, sequence B)
        return self.norm(out + self.dropout(out))


class GlobalAttention(nn.Module):
    """Attention and MLP residuals, each under DropPath 0.1
    (tdanet.py:251-261)."""

    def __init__(self, channels: int, drop_path: float = 0.1, device=None):
        super().__init__()
        self.attn = TDAAttention(channels, device=device)
        self.mlp = Mlp(channels, 2 * channels, device=device)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.attn(x))
        return x + self.drop_path(self.mlp(x))


class InjectionMultiSum(nn.Module):
    """Sigmoid-gated local/global fusion (tdanet.py:264-290): the global
    input's gate and embedding resized to the local length (nearest)."""

    def __init__(self, inp: int, oup: int, kernel: int = 1, device=None):
        super().__init__()
        groups = inp if inp == oup else 1
        for name in ("local_embedding", "global_embedding", "global_act"):
            setattr(self, name, ConvNorm(inp, oup, kernel, groups=groups, bias=False, device=device))

    def forward(self, x_local: torch.Tensor, x_global: torch.Tensor) -> torch.Tensor:
        T = x_local.shape[1]
        sig = interpolate_nearest(torch.sigmoid(self.global_act(x_global)), T, dim=1)
        g_feat = interpolate_nearest(self.global_embedding(x_global), T, dim=1)
        return self.local_embedding(x_local) * sig + g_feat


class TDAUConvBlock(nn.Module):
    """Pyramid, global attention and injection fusion (tdanet.py:293-368),
    [B, T, out_channels] -> same."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, upsampling_depth: int = 4,
                 device=None):
        super().__init__()
        C, D = in_channels, upsampling_depth
        self.depth = D
        self.proj_1x1 = ConvNormAct(out_channels, C, 1, device=device)
        self.spp_dw = nn.ModuleList([DilatedConvNorm(C, C, 5, stride=1 if k == 0 else 2, groups=C,
                                                     device=device) for k in range(D)])
        self.globalatt = GlobalAttention(C, device=device)
        self.loc_glo_fus = nn.ModuleList([InjectionMultiSum(C, C, device=device) for _ in range(D)])
        self.last_layer = nn.ModuleList([InjectionMultiSum(C, C, 5, device=device)
                                         for _ in range(D - 1)])
        self.res_conv = nn.Conv1d(C, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pyramid = [self.spp_dw[0](self.proj_1x1(x))]
        for conv in self.spp_dw[1:]:
            pyramid.append(conv(pyramid[-1]))
        T_last = pyramid[-1].shape[1]
        global_f = self.globalatt(sum(adaptive_avg_pool1d(f, T_last, dim=1) for f in pyramid))
        fused = [fus(f, global_f) for fus, f in zip(self.loc_glo_fus, pyramid)]
        expanded = None
        for i in range(self.depth - 2, -1, -1):
            other = fused[i - 1] if i == self.depth - 2 else expanded
            expanded = self.last_layer[i](fused[i], other)
        return conv1d_channels_last(self.res_conv, expanded) + x


class Recurrent(nn.Module):
    """``iters`` applications of the block with the input re-injected
    through a depthwise gate (tdanet.py:371-404): one shared block and gate
    with ``unfold``, else a block each (``unet.{i}``) and a gate each
    (``concat_block.{i - 1}``)."""

    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int, iters: int,
                 unfold: bool = True, device=None):
        super().__init__()
        self.iters, self.unfold = iters, unfold

        def block():
            return TDAUConvBlock(out_channels, in_channels, upsampling_depth, device=device)

        def gate():
            return DepthwiseGate(out_channels, conv_dims=1, device=device)

        if unfold:
            self.unet, self.concat_block = block(), gate()
        else:
            self.unet = nn.ModuleList([block() for _ in range(iters)])
            self.concat_block = nn.ModuleList([gate() for _ in range(iters - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mixture = x
        for i in range(self.iters):
            block = self.unet if self.unfold else self.unet[i]
            if i > 0:
                x = (self.concat_block if self.unfold else self.concat_block[i - 1])(mixture + x)
            x = block(x)
        return x


class MaskedFilterbank(BaseModel):
    """The shell TDANet and AFRCNN share: a bias-free conv encoder of
    ``enc_kernel_size`` ms (stride k // 4, k // 2 + 1 filters) on the
    padded wave, gLN, a 1x1 bottleneck, the separator ``sm``, PReLU and a 1x1
    to one mask per speaker (``mask_net``), mask x encoding, and the
    transposed-conv decoder, cropped to the input (reference
    tdanet.py:431-527).  Subclasses build ``sm``."""

    def _build_shell(self, device):
        k = self.enc_kernel_size * self.sample_rate // 1000
        basis, spk = k // 2 + 1, self.num_sources
        self.encoder = nn.Conv1d(1, basis, k, stride=k // 4, padding=k // 2, bias=False, device=device)
        self.ln = GlobalLayerNorm(basis, eps=1e-8, channels_last=True, device=device)
        self.bottleneck = nn.Conv1d(basis, self.out_channels, 1, device=device)
        self.mask_net = nn.Sequential(PReLU(device=device),
                                      nn.Conv1d(self.out_channels, spk * basis, 1, device=device))
        self.decoder = nn.ConvTranspose1d(spk * basis, spk, k, stride=k // 4, bias=False, device=device)

    def encode(self, x: torch.Tensor):
        """[B, T] -> (encoding [B, T', basis], bottleneck output [B, T',
        out_channels], the right padding ``rest``)."""
        k = self.encoder.kernel_size[0]
        stride = k // 4
        rest = k - (stride + x.shape[1] % k) % k
        x = F.pad(x, (k - stride + k // 2, rest + k - stride + k // 2))
        frames = frame_signal(x, k, stride)  # [B, T', k]
        enc = torch.matmul(frames, self.encoder.weight[:, 0, :].to(x.dtype).t())
        return enc, conv1d_channels_last(self.bottleneck, self.ln(enc)), rest

    def decode(self, h: torch.Tensor, enc: torch.Tensor, rest: int) -> torch.Tensor:
        """Separator output [B, T', out_channels] -> estimates [B, spk, T]."""
        B, Tp, basis = enc.shape
        spk = self.num_sources
        k = self.decoder.kernel_size[0]
        stride = k // 4
        h = conv1d_channels_last(self.mask_net[1], self.mask_net[0](h))
        masked = (torch.relu(h.reshape(B, Tp, spk, basis)) * enc[:, :, None, :]).reshape(B, Tp, -1)
        frames = torch.einsum("btc,cok->botk", masked, self.decoder.weight.to(masked.dtype))
        dec = overlap_add(frames.reshape(B * spk, Tp, k), stride).reshape(B, spk, -1)
        crop = k // 2 + k - stride
        return dec[:, :, crop: dec.shape[-1] - (k // 2 + rest + k - stride)]

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x, was_one_d = normalize_input(wav)
        enc, h, rest = self.encode(x)
        return restore_output(self.decode(self.sm(h), enc, rest), was_one_d)


@register_model
class TDANet(MaskedFilterbank):
    """TDANet with the arguments of ``configs/tdanet_lrs2.yml``'s
    ``audionet_config``.  ``generator`` seeds the initial weights (none:
    seed 0); ``device`` places them."""

    def __init__(self, out_channels=128, in_channels=512, num_blocks=16, upsampling_depth=4,
                 enc_kernel_size=21, num_sources=2, sample_rate=16000, unfold=True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_channels, self.in_channels, self.num_blocks = out_channels, in_channels, num_blocks
        self.upsampling_depth, self.enc_kernel_size = upsampling_depth, enc_kernel_size
        self.num_sources, self.sample_rate, self.unfold = num_sources, sample_rate, unfold
        self._build_shell(device)
        self.sm = Recurrent(out_channels, in_channels, upsampling_depth, num_blocks, unfold, device)
        seeded_init_(self, generator)


# ---- the analytic-moment eval forward (tdanet.py:300-649 in the JAX package)


def _moments_tc(x: torch.Tensor):
    """Per-(batch, channel) mean and second moment over time, float32: [B, C]."""
    xf = x.float()
    return xf.mean(dim=1), xf.square().mean(dim=1)


def _gln_affine(mu_c, q_c, norm: GlobalLayerNorm):
    """gLN as a per-channel affine (a, c) [B, 1, C] from per-channel
    moments; the E[x^2] - mu^2 variance clamped at 0."""
    mu = mu_c.mean(dim=-1)[:, None, None]
    var = torch.clamp(q_c.mean(dim=-1)[:, None, None] - mu * mu, min=0.0)
    a = norm.weight.float()[None, None, :] * torch.rsqrt(var + norm.eps)
    return a, norm.bias.float()[None, None, :] - mu * a


def _globalatt_eval(ga: GlobalAttention, x: torch.Tensor) -> torch.Tensor:
    """``GlobalAttention`` in eval mode, the attention in the plain einsum
    form over the batch axis."""
    att = ga.attn
    h = att.pos_enc(att.attn_in_norm(x)).transpose(0, 1)
    m = att.attn
    o = mha_plain_form(h, h, h, m.in_proj_weight, m.in_proj_bias, m.out_proj.weight,
                       m.out_proj.bias, m.num_heads).transpose(0, 1)
    x = x + att.norm(o + o)
    return x + ga.mlp.fc2(ga.mlp.hidden(x))


def _uconv_fast(u: TDAUConvBlock, xin: torch.Tensor) -> torch.Tensor:
    """One ``TDAUConvBlock`` in eval mode with the pyramid's gLNs folded:
    only the raw depthwise outputs d_k and their moments are kept."""
    dt = xin.dtype
    m = conv1d_channels_last(u.proj_1x1.conv, xin)
    a, c = _gln_affine(*_moments_tc(m), u.proj_1x1.norm)
    d = conv1d_channels_last(u.spp_dw[0].conv, u.proj_1x1.act(m * a.to(dt) + c.to(dt)))
    ds, affs, mus, qs = [], [], [], []
    for kk in range(u.depth):
        if kk > 0:
            # the previous scale's gLN a*d + c folded into this conv: a*conv(d)
            # + c * (sum of the taps inside the zero padding) + bias; with
            # stride 2, 5 taps and padding 2 only rows 0 (taps 0, 1) and
            # T_out - 1 (tap 4, and tap 3 when T_in is odd) lose taps
            conv = u.spp_dw[kk].conv
            w5 = conv.weight[:, 0, :].float().t()  # [5, C]
            a_p, c_p = affs[-1]
            T_in = d.shape[1]
            raw = F.conv1d(d.transpose(1, 2), conv.weight.to(dt), None, 2, 2,
                           groups=conv.groups).transpose(1, 2)
            T_out = raw.shape[1]
            base = w5.sum(dim=0)[None, None, :] * c_p + conv.bias.float()[None, None, :]
            dn = a_p.to(dt) * raw + base.to(dt)
            row = torch.arange(T_out, device=d.device)[None, :, None]
            head = ((w5[0] + w5[1])[None, None, :] * c_p).to(dt)
            dn = dn - torch.where(row == 0, head, 0.0)
            tail_w = w5[4] + (w5[3] if T_in % 2 == 1 else 0.0)
            dn = dn - torch.where(row == T_out - 1, (tail_w[None, None, :] * c_p).to(dt), 0.0)
            d = dn
        mu_c, q_c = _moments_tc(d)
        ds.append(d)
        mus.append(mu_c)
        qs.append(q_c)
        affs.append(_gln_affine(mu_c, q_c, u.spp_dw[kk].norm))

    # the pooled sum at the deepest resolution (pooling commutes with the affine)
    T_last = ds[-1].shape[1]
    g = sum(a_k.to(dt) * adaptive_avg_pool1d(d_k, T_last, dim=1) + c_k.to(dt)
            for d_k, (a_k, c_k) in zip(ds, affs))
    g = _globalatt_eval(u.globalatt, g)

    # fus_i: the local branch, a depthwise 1x1 and gLN of the normalised
    # scale, is an affine of the raw d_i through moment propagation
    fused = []
    for i, fus in enumerate(u.loc_glo_fus):
        local = fus.local_embedding
        wl = local.conv.weight[:, 0, 0].float()
        a2, c2 = affs[i][0][:, 0, :], affs[i][1][:, 0, :]  # [B, C]
        mv = wl[None, :] * (a2 * mus[i] + c2)
        qv = wl.square()[None, :] * (a2.square() * qs[i] + 2.0 * a2 * c2 * mus[i] + c2.square())
        muv = mv.mean(dim=-1)[:, None]
        rstd = torch.rsqrt(torch.clamp(qv.mean(dim=-1)[:, None] - muv.square(), min=0.0)
                           + local.norm.eps)
        g_l, b_l = local.norm.weight.float()[None, :], local.norm.bias.float()[None, :]
        A = g_l * rstd * wl[None, :] * a2
        C = g_l * rstd * (wl[None, :] * c2 - muv) + b_l
        T_i = ds[i].shape[1]
        sig = interpolate_nearest(torch.sigmoid(fus.global_act(g)), T_i, dim=1)
        gf = interpolate_nearest(fus.global_embedding(g), T_i, dim=1)
        fused.append((A[:, None, :].to(dt) * ds[i] + C[:, None, :].to(dt)) * sig + gf)

    # the top-down collapse, with the reference's fused[i - 1] at i == depth - 2
    expanded = None
    for i in range(u.depth - 2, -1, -1):
        other = fused[i - 1] if i == u.depth - 2 else expanded
        expanded = u.last_layer[i](fused[i], other)
    return conv1d_channels_last(u.res_conv, expanded) + xin


def fast_forward_eligible(model) -> bool:
    """The analytic fast path serves the weight-shared TDANets."""
    return isinstance(model, TDANet) and model.unfold and model.upsampling_depth >= 2


def fast_inference_forward(model: TDANet, wav: torch.Tensor) -> torch.Tensor:
    """TDANet's eval forward through the analytic-moment blocks, in the
    module's and the input's dtype (both bf16, or both float32); dropout
    and DropPath are the identity.  Raises for a model that
    ``fast_forward_eligible`` refuses."""
    if not fast_forward_eligible(model):
        raise ValueError("fast_inference_forward serves a TDANet with unfold and "
                         "upsampling_depth >= 2; run the module itself")
    x, was_one_d = normalize_input(wav)
    enc, h, rest = model.encode(x)
    sm = model.sm
    out = _uconv_fast(sm.unet, h)
    for _ in range(1, model.num_blocks):
        out = _uconv_fast(sm.unet, sm.concat_block(h + out))
    return restore_output(model.decode(out, enc, rest), was_one_d)
