"""Sepformer, the dual-path transformer (counterpart of
``audio_only_speech_separation_tpu/models/sepformer.py``; reference
sepformer.py:578-1020).

Forward: a ReLU conv encoder (no input padding) -> gLN (eps 1e-8) and a
bias-free 1x1 -> 50%-overlap chunking (K = masknet_chunksize) ->
masknet_numlayers dual blocks, each with its own intra and inter
transformer stack (pre- or post-norm layers, LayerNorm eps 1e-6, fixed
sinusoidal positions added in the activations' dtype, a final LayerNorm,
an optional causal mask) and a gLN + residual after each -> PReLU -> a 1x1
to the speakers as a channel product on [B, N, K, S] -> overlap-add -> the
gated tanh * sigmoid output -> a bias-free 1x1 -> ReLU mask -> mask x
encoding -> the transposed-conv decoder, padded or cropped to the input
length.  Dropout (0.1 by default: the attention weights, both residual
branches and inside the feed-forward) acts only while training.

Serving through the kernels is this module itself, cast to bf16 on a CUDA
device, in eval mode: every unmasked attention takes K4 from inside
``ops/attention.py``.  A mask (``*_causal``) or training dropout takes the
plain attention form, as in the JAX package.

The ``state_dict`` uses look2hear's keys (the JAX package's
``utils/torch_import.py::convert_sepformer``): ``encoder.conv1d.weight``
[N, 1, k], ``masknet.norm``, ``masknet.conv1d.weight``,
``masknet.dual_mdl.{i}.{intra,inter}_mdl.mdl.layers.{j}.{self_att.att.*,
norm1, norm2, pos_ffn.ffn.0, pos_ffn.ffn.3}``, ``...{side}_mdl.mdl.norm``,
``masknet.dual_mdl.{i}.{side}_norm``, ``masknet.prelu``, ``masknet.conv2d``,
``masknet.output.0``, ``masknet.output_gate.0``, ``masknet.end_conv1x1``
and ``decoder.weight`` [N, 1, k].

Under a mesh with an ``sp`` axis (``parallel/sequence.py``; the JAX
package's ``shard_chunks``) each dual block runs its intra stack on this
rank's chunks S and its inter stack on its positions K, with the gLNs over
the whole sample, an exchange between, and one gather after the last
block.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.activations import PReLU
from ..ops.attention import MultiheadAttention, PositionalEncoding
from ..ops.chunk import merge_feature, split_feature
from ..ops.conv import frame_signal, overlap_add
from ..ops.dropout import Dropout
from ..ops.norms import GlobalLayerNorm
from ..parallel import sequence
from ..utils.profiling import span
from . import register_model
from .base import BaseModel, _arg_names, normalize_input, restore_output


def _pointwise(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """1x1 ``conv`` on [B, C, T] as a channel product in x's dtype."""
    y = torch.matmul(conv.weight[:, :, 0].to(x.dtype), x)
    return y if conv.bias is None else y + conv.bias.to(y.dtype)[:, None]


class _SelfAttention(nn.Module):
    """look2hear's wrapper: the attention under ``.att``."""

    def __init__(self, d_model: int, nhead: int, dropout: float, device=None):
        super().__init__()
        self.att = MultiheadAttention(d_model, nhead, dropout=dropout, device=device)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return self.att(x, mask=mask)


class _FeedForward(nn.Module):
    """Linear -> ReLU -> dropout -> Linear, under ``.ffn`` (keys ffn.0, ffn.3)."""

    def __init__(self, d_model: int, d_ffn: int, dropout: float, device=None):
        super().__init__()
        self.ffn = nn.Sequential(nn.Linear(d_model, d_ffn, device=device), nn.ReLU(),
                                 Dropout(dropout), nn.Linear(d_ffn, d_model, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn(x)


class SBTransformerLayer(nn.Module):
    """Pre- or post-norm transformer encoder layer on [B, T, d]
    (sepformer.py:278-365)."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, norm_before: bool = True,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.norm_before = norm_before
        self.self_att = _SelfAttention(d_model, nhead, dropout, device)
        self.pos_ffn = _FeedForward(d_model, d_ffn, dropout, device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.dropout1, self.dropout2 = Dropout(dropout), Dropout(dropout)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        if self.norm_before:
            x = x + self.dropout1(self.self_att(self.norm1(x), mask))
            return x + self.dropout2(self.pos_ffn(self.norm2(x)))
        x = self.norm1(x + self.dropout1(self.self_att(x, mask)))
        return self.norm2(x + self.dropout2(self.pos_ffn(x)))


class _LayerStack(nn.Module):
    """The layers under ``.layers`` and the final LayerNorm ``.norm``."""

    def __init__(self, num_layers: int, d_model: int, make_layer, device=None):
        super().__init__()
        self.layers = nn.ModuleList([make_layer() for _ in range(num_layers)])
        self.norm = nn.LayerNorm(d_model, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, mask)
        return self.norm(x)


class SBTransformerBlock(nn.Module):
    """``num_layers`` transformer layers and a final LayerNorm, with
    optional sinusoidal positions and causal mask (sepformer.py:469-558);
    the stack sits under ``.mdl``."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, d_ffn: int = 2048,
                 use_positional_encoding: bool = False, norm_before: bool = False,
                 is_causal: bool = False, dropout: float = 0.1, device=None):
        super().__init__()
        self.is_causal = is_causal
        self.pos_enc = PositionalEncoding(d_model) if use_positional_encoding else None
        self.mdl = _LayerStack(num_layers, d_model, lambda: SBTransformerLayer(
            d_model, nhead, d_ffn, norm_before, dropout, device), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mask = None
        if self.is_causal:
            T = x.shape[1]
            mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))[None, None]
        if self.pos_enc is not None:
            x = self.pos_enc(x)
        return self.mdl(x, mask)


class DualComputationBlock(nn.Module):
    """Intra- then inter-chunk transformer, each followed by gLN and a
    residual, on [B, N, K, S] (sepformer.py:578-642)."""

    def __init__(self, out_channels: int, intra_kwargs: dict, inter_kwargs: dict, device=None):
        super().__init__()
        self.intra_mdl = SBTransformerBlock(**intra_kwargs, device=device)
        self.inter_mdl = SBTransformerBlock(**inter_kwargs, device=device)
        self.intra_norm = GlobalLayerNorm(out_channels, eps=1e-8, device=device)
        self.inter_norm = GlobalLayerNorm(out_channels, eps=1e-8, device=device)

    def forward(self, x: torch.Tensor, S: int | None = None) -> torch.Tensor:
        """x [B, N, K, S] -> [B, N, K, S]; under an ``sp`` mesh x holds this
        rank's chunks of the S (given) and the result its positions of K.
        Spans ``sepformer.intra`` and ``sepformer.inter`` cover the host's
        issue of each transformer stack."""
        B, N, K, S_r = x.shape
        S = S_r if S is None else S
        group = sequence.sp_group()
        with span("sepformer.intra"):
            intra = self.intra_mdl(x.permute(0, 3, 2, 1).reshape(B * S_r, K, N))
        intra = intra.reshape(B, S_r, K, N).permute(0, 3, 2, 1)
        intra = sequence.exchange(self.intra_norm(intra, group) + x, 2, 3, S)  # [B, N, K_r, S]
        K_r = intra.shape[2]
        with span("sepformer.inter"):
            inter = self.inter_mdl(intra.permute(0, 2, 3, 1).reshape(B * K_r, S, N))
        inter = inter.reshape(B, K_r, S, N).permute(0, 3, 1, 2)
        return self.inter_norm(inter, group) + intra


class _Encoder(nn.Module):
    """look2hear's encoder: the filterbank under ``.conv1d`` (no bias)."""

    def __init__(self, out_channels: int, kernel_size: int, device=None):
        super().__init__()
        self.conv1d = nn.Conv1d(1, out_channels, kernel_size, stride=kernel_size // 2, bias=False,
                                device=device)


class _MaskNet(nn.Module):
    """look2hear's ``Dual_Path_Model`` parameters: gLN, the 1x1 in, the
    dual blocks, PReLU, the 1x1 to the speakers and the gated output."""

    def __init__(self, N: int, spks: int, num_layers: int, intra_kwargs: dict, inter_kwargs: dict,
                 device=None):
        super().__init__()
        self.norm = GlobalLayerNorm(N, eps=1e-8, device=device)
        self.conv1d = nn.Conv1d(N, N, 1, bias=False, device=device)
        self.dual_mdl = nn.ModuleList([DualComputationBlock(N, intra_kwargs, inter_kwargs, device)
                                       for _ in range(num_layers)])
        self.prelu = PReLU(device=device)
        self.conv2d = nn.Conv2d(N, N * spks, 1, device=device)
        self.output = nn.Sequential(nn.Conv1d(N, N, 1, device=device), nn.Tanh())
        self.output_gate = nn.Sequential(nn.Conv1d(N, N, 1, device=device), nn.Sigmoid())
        self.end_conv1x1 = nn.Conv1d(N, N, 1, bias=False, device=device)


@register_model
class Sepformer(BaseModel):
    """Sepformer with the arguments of ``configs/sepformer_base.yml``'s
    ``audionet_config``.  Only gLN (``masknet_norm``) and a one-channel
    input are built, as in the JAX package.  ``generator`` seeds the initial
    weights (none: seed 0); ``device`` places them."""

    def __init__(self, encoder_kernel_size=16, encoder_in_nchannels=1, encoder_out_nchannels=256,
                 masknet_chunksize=250, masknet_numlayers=2, masknet_norm="gLN", masknet_numspks=2,
                 intra_numlayers=8, inter_numlayers=8, intra_nhead=8, inter_nhead=8,
                 intra_dffn=1024, inter_dffn=1024, intra_use_positional=True,
                 inter_use_positional=True, intra_norm_before=True, inter_norm_before=True,
                 intra_causal=False, inter_causal=False, dropout=0.1, sample_rate=8000,
                 device=None, generator: torch.Generator | None = None):
        args = dict(locals())
        super().__init__()
        if masknet_norm != "gLN" or encoder_in_nchannels != 1:
            raise NotImplementedError("Sepformer: only masknet_norm 'gLN' and one input channel "
                                      "are built, as in the JAX package")
        for name in _arg_names(Sepformer):
            setattr(self, name, args[name])
        N = encoder_out_nchannels
        intra_kwargs = dict(num_layers=intra_numlayers, d_model=N, nhead=intra_nhead,
                            d_ffn=intra_dffn, use_positional_encoding=intra_use_positional,
                            norm_before=intra_norm_before, is_causal=intra_causal, dropout=dropout)
        inter_kwargs = dict(num_layers=inter_numlayers, d_model=N, nhead=inter_nhead,
                            d_ffn=inter_dffn, use_positional_encoding=inter_use_positional,
                            norm_before=inter_norm_before, is_causal=inter_causal, dropout=dropout)
        self.encoder = _Encoder(N, encoder_kernel_size, device)
        self.masknet = _MaskNet(N, masknet_numspks, masknet_numlayers, intra_kwargs, inter_kwargs,
                                device)
        self.decoder = nn.ConvTranspose1d(N, 1, encoder_kernel_size, stride=encoder_kernel_size // 2,
                                          bias=False, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Seeded init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
        biases, unit norms, PReLU 0.25."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if "norm" in name and p.ndim == 1:
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif name == "masknet.prelu.weight":
                    p.fill_(0.25)
                else:
                    fan_in = p.shape[1] * int(np.prod(p.shape[2:])) if p.ndim > 1 else p.shape[0]
                    p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) / math.sqrt(fan_in))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x, was_one_d = normalize_input(wav)
        B, T = x.shape
        N, k, spks, K = (self.encoder_out_nchannels, self.encoder_kernel_size, self.masknet_numspks,
                         self.masknet_chunksize)
        mnet = self.masknet

        frames = frame_signal(x, k, k // 2)  # [B, L, k]
        w_enc = self.encoder.conv1d.weight[:, 0, :].to(x.dtype)
        mix_w = torch.relu(torch.matmul(frames, w_enc.t())).transpose(1, 2)  # [B, N, L]
        L = mix_w.shape[-1]

        h = _pointwise(mnet.conv1d, mnet.norm(mix_w))
        chunks, gap = split_feature(h, K)  # [B, N, K, S]
        S = chunks.shape[-1]
        chunks = sequence.shard(chunks, 3)  # this rank's chunks (all of them off an sp mesh)
        for i, block in enumerate(mnet.dual_mdl):
            if i:
                chunks = sequence.exchange(chunks, 3, 2, K)
            chunks = block(chunks, S)
        h = mnet.prelu(sequence.gather(chunks, 2, K))
        S = h.shape[-1]
        w2 = mnet.conv2d.weight[:, :, 0, 0].to(h.dtype)  # [N * spks, N]
        h = torch.matmul(w2, h.reshape(B, N, K * S)) + mnet.conv2d.bias.to(h.dtype)[:, None]
        h = merge_feature(h.reshape(B * spks, N, K, S), gap)  # [B * spks, N, L]

        gated = torch.tanh(_pointwise(mnet.output[0], h)) * torch.sigmoid(
            _pointwise(mnet.output_gate[0], h))
        est_mask = torch.relu(_pointwise(mnet.end_conv1x1, gated).reshape(B, spks, N, L))
        sep_h = (mix_w[:, None] * est_mask).reshape(B * spks, N, L)

        w_dec = self.decoder.weight[:, 0, :].to(sep_h.dtype)  # [N, k]
        est = overlap_add(torch.matmul(sep_h.transpose(1, 2), w_dec), k // 2).reshape(B, spks, -1)
        T_est = est.shape[-1]
        est = nn.functional.pad(est, (0, T - T_est)) if T > T_est else est[:, :, :T]
        return restore_output(est, was_one_d)
