"""TasNet with a pluggable separator (counterpart of
``audio_only_speech_separation_tpu/models/tasnet.py``; reference
gc3_network.py:7-188), for every ``module`` the JAX model takes: DPRNN,
DPTNet, TCN, SudoRMRF, GC_TCN and GC_SudoRMRF, with group communication
(``group_size`` > 1) and ``unfold``.

Forward (gc3_network.py:133-184): pad to the window, a bias-free conv
encoder, gLN (float32 eps) and a bias-free 1x1 bottleneck; with
``group_size`` G > 1 a context squeeze (windows of ``context_size``
frames, a two-layer bidirectional ``GC_RNN``, the mean over each window);
the separator (DPRNN/DPTNet cores on 50%-overlap chunks, merged back; the
TCN stack; or ``layer`` U-ConvBlocks); with G > 1 the context decode
(the separator's output added back to every frame of its window, a
second ``GC_RNN``, overlap-add); a 1x1 + relu mask per group and speaker,
mask x encoding, the transposed-conv decoder, crop.

Serving through the kernels is this module itself, cast to bf16 on a CUDA
device: its attention and LSTM layers dispatch to K4, K5 and K6
(``ops/attention.py``, ``ops/rnn.py``); TCN and SudoRM-RF run no kernel.

The ``state_dict`` uses look2hear's keys: ``encoder.weight`` [enc, 1, win],
``bottleneck.0.{weight,bias}``, ``bottleneck.1.weight``,
``context_{enc,dec}.*`` (G > 1), the separator under
``seq_model.seq_model`` (DPRNN, DPTNet), ``seq_model.tcn`` (TCN, GC_TCN)
or ``seq_model.sudo_rmrf_layers.{i}`` (SudoRMRF, GC_SudoRMRF),
``mask.0.{weight,bias}`` and ``decoder.weight`` [enc, 1, win].  Under a
mesh with an ``sp`` axis the DPRNN and DPTNet cores share each sample's
chunks across the ``sp`` group (``parallel/sequence.py``); the rest runs
whole on every rank.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.chunk import merge_feature, split_feature
from ..ops.conv import frame_signal, overlap_add
from ..ops.activations import PReLU
from ..ops.norms import GlobalLayerNorm
from ..ops.rnn import _LSTMParams
from . import register_model
from .base import BaseModel, normalize_input, restore_output
from .blocks import GC_RNN, GC_TCN, TCN, DPRNNCore, DPTNetCore, GC_UConvBlock, UConvBlock

_F32_EPS = float(np.finfo(np.float32).eps)
MODULES = ("DPRNN", "DPTNet", "TCN", "SudoRMRF", "GC_TCN", "GC_SudoRMRF")


class _SeqModel(nn.Module):
    """look2hear's wrapper: the separator under the attribute ``name``
    (``seq_model``, ``tcn`` or ``sudo_rmrf_layers``)."""

    def __init__(self, name: str, separator: nn.Module):
        super().__init__()
        setattr(self, name, separator)


@register_model
class TasNet(BaseModel):
    """TasNet shell around any of ``MODULES``.  ``generator`` seeds the
    initial weights (none: seed 0); ``device`` places them."""

    def __init__(self, enc_dim=64, bn_dim=64, hidden_dim=128, win=16, layer=6, num_spk=2,
                 module="DPRNN", context_size=24, group_size=1, block_size=100,
                 sample_rate=16000, unfold=False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if module not in MODULES:
            raise ValueError(f"TasNet module {module!r}: not one of {MODULES}")
        self.enc_dim, self.bn_dim, self.hidden_dim, self.win = enc_dim, bn_dim, hidden_dim, win
        self.layer, self.num_spk, self.module, self.context_size = layer, num_spk, module, context_size
        self.group_size, self.block_size, self.sample_rate = group_size, block_size, sample_rate
        self.unfold = unfold
        stride = win // 2
        self.encoder = nn.Conv1d(1, enc_dim, win, stride=stride, bias=False, device=device)
        self.bottleneck = nn.Sequential(
            GlobalLayerNorm(enc_dim, eps=_F32_EPS, device=device),
            nn.Conv1d(enc_dim, bn_dim, 1, bias=False, device=device),
        )
        G = group_size
        if G > 1:
            gc = dict(num_group=G, num_layers=2, bidirectional=True, device=device)
            self.context_enc = GC_RNN(bn_dim, hidden_dim, **gc)
            self.context_dec = GC_RNN(bn_dim, hidden_dim, **gc)
        if module in ("DPRNN", "DPTNet"):
            kw = dict(input_size=bn_dim, hidden_size=hidden_dim, output_size=bn_dim, num_group=G,
                      num_layers=layer, unfold=unfold, device=device)
            self.seq_model = _SeqModel("seq_model", DPRNNCore(**kw) if module == "DPRNN" else DPTNetCore(**kw))
        elif module == "TCN":
            self.seq_model = _SeqModel("tcn", TCN(bn_dim, bn_dim, hidden_dim, bn_dim * 4, layer, stack=2,
                                                  kernel=3, device=device))
        elif module == "GC_TCN":
            self.seq_model = _SeqModel("tcn", GC_TCN(bn_dim, bn_dim, bn_dim * 4, layer, stack=2, kernel=3,
                                                     num_group=G, device=device))
        else:
            kw = dict(out_channels=bn_dim, in_channels=hidden_dim * 2, upsampling_depth=5, device=device)
            blocks = [GC_UConvBlock(**kw, num_group=G) if module == "GC_SudoRMRF" else UConvBlock(**kw)
                      for _ in range(layer)]
            self.seq_model = _SeqModel("sudo_rmrf_layers", nn.ModuleList(blocks))
        self.mask = nn.Sequential(nn.Conv1d(bn_dim // G, enc_dim * num_spk // G, 1, device=device))
        self.decoder = nn.ConvTranspose1d(enc_dim, 1, win, stride=stride, bias=False, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Seeded init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
        biases (U(-1/sqrt(H), 1/sqrt(H)) for the LSTMs, torch's default, with
        H the TasNet's ``hidden_dim`` in a core of one group and the layer's
        own width elsewhere), unit norms, PReLU 0.25, unit gates."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        owner = {f"{mn}.{pn}" if mn else pn: m for mn, m in self.named_modules()
                 for pn, _ in m.named_parameters(recurse=False)}
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf, m = name.rsplit(".", 1)[-1], owner[name]
                if isinstance(m, (GlobalLayerNorm, nn.LayerNorm)):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif "concat_block" in name:
                    p.fill_(0.25 if ".1." in name else (1.0 if leaf == "weight" else 0.0))
                elif isinstance(m, PReLU):
                    p.fill_(0.25)
                else:
                    if isinstance(m, _LSTMParams):
                        core = name.startswith("seq_model.seq_model.") and self.group_size == 1
                        bound = 1.0 / math.sqrt(self.hidden_dim if core else m.hidden_size)
                    else:
                        fan_in = p.shape[1] * int(np.prod(p.shape[2:])) if p.ndim > 1 else p.shape[0]
                        bound = 1.0 / math.sqrt(fan_in)
                    p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * bound)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x, was_one_d = normalize_input(wav)
        B, T = x.shape
        stride = self.win // 2
        rest = self.win - (stride + T % self.win) % self.win
        x = nn.functional.pad(x, (0, rest) if rest > 0 else (0, 0))
        x = nn.functional.pad(x, (stride, stride))

        frames = frame_signal(x, self.win, stride)  # [B, T', win]
        enc = torch.matmul(frames, self.encoder.weight[:, 0, :].to(x.dtype).t()).transpose(1, 2)
        feat = self.bottleneck[0](enc)
        feat = torch.matmul(self.bottleneck[1].weight[:, :, 0].to(feat.dtype), feat)  # [B, bn, T']
        G, bn, ctx = self.group_size, self.bn_dim, self.context_size

        if G > 1:  # context squeeze: GC_RNN over each window, then its mean
            sq_blocks, sq_rest = split_feature(feat, ctx)  # [B, bn, ctx, L]
            L = sq_blocks.shape[-1]
            sq = self.context_enc(sq_blocks.permute(0, 3, 1, 2).reshape(B * L, bn, ctx))
            feat = sq.mean(dim=2).reshape(B, L, bn).transpose(1, 2)  # [B, bn, L]
        frames_n = feat.shape[-1]

        if self.module in ("DPRNN", "DPTNet"):
            blocks, blk_rest = split_feature(feat, self.block_size)  # [B, bn, K, S]
            core = self.seq_model.seq_model(blocks).reshape(B, bn, self.block_size, -1)
            fmap = merge_feature(core, blk_rest)  # [B, bn, frames]
        elif self.module in ("TCN", "GC_TCN"):
            fmap = self.seq_model.tcn(feat)
        else:
            fmap = feat
            for block in self.seq_model.sudo_rmrf_layers:
                fmap = block(fmap)
        fmap = fmap.reshape(B, -1, frames_n)

        if G > 1:  # context decode
            fm = (fmap[:, :, None, :] + sq_blocks).permute(0, 3, 1, 2).reshape(B * frames_n, bn, ctx)
            dec = self.context_dec(fm).reshape(B, frames_n, bn, ctx).permute(0, 2, 3, 1)
            fmap = merge_feature(dec, sq_rest)  # [B, bn, T']

        conv = self.mask[0]  # per group: [B*G, bn/G, T'] -> [B, spk, enc, T']
        fmap = fmap.reshape(B * G, bn // G, -1)
        m = torch.matmul(conv.weight[:, :, 0].to(fmap.dtype), fmap) + conv.bias.to(fmap.dtype)[:, None]
        m = torch.relu(m).reshape(B, G, self.num_spk, self.enc_dim // G, -1).transpose(1, 2)
        m = m.reshape(B, self.num_spk, self.enc_dim, -1)
        masked = (m * enc[:, None]).reshape(B * self.num_spk, self.enc_dim, -1)

        dec = torch.matmul(masked.transpose(1, 2), self.decoder.weight[:, 0, :].to(masked.dtype))
        out = overlap_add(dec, stride)  # [B * spk, T + rest + 2 * stride]
        out = out[:, stride: out.shape[-1] - (rest + stride)]
        return restore_output(out.reshape(B, self.num_spk, -1), was_one_d)
