"""TasNet with a dual-path separator (counterpart of
``audio_only_speech_separation_tpu/models/tasnet.py``; reference
gc3_network.py:7-188), for ``module`` DPRNN or DPTNet with
``group_size == 1``.

Forward (gc3_network.py:133-184): pad to the window, a bias-free conv
encoder, gLN (float32 eps) and a bias-free 1x1 bottleneck, 50%-overlap
chunking, the dual-path core, overlap-add, a 1x1 + relu mask per speaker,
mask x encoding, the transposed-conv decoder, crop.

Serving through the kernels is this module itself, cast to bf16 on a CUDA
device: its attention and LSTM layers dispatch to K4, K5 and K6
(``ops/attention.py``, ``ops/rnn.py``).

The ``state_dict`` uses look2hear's keys: ``encoder.weight`` [enc, 1, win],
``bottleneck.0.{weight,bias}``, ``bottleneck.1.weight``,
``seq_model.seq_model.*`` (the core), ``mask.0.{weight,bias}`` and
``decoder.weight`` [enc, 1, win].  The other separator modules (TCN,
SudoRMRF, GC_*), group communication (``group_size > 1``) and the sequence
sharding of the JAX package are still to port (ROADMAP Queue 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.chunk import merge_feature, split_feature
from ..ops.conv import frame_signal, overlap_add
from ..ops.norms import GlobalLayerNorm
from . import register_model
from .base import BaseModel, normalize_input, restore_output
from .blocks import DPRNNCore, DPTNetCore

_F32_EPS = float(np.finfo(np.float32).eps)
MODULES = ("DPRNN", "DPTNet")


class _SeqModel(nn.Module):
    """look2hear's wrapper: the core under ``.seq_model``."""

    def __init__(self, core: nn.Module):
        super().__init__()
        self.seq_model = core


@register_model
class TasNet(BaseModel):
    """TasNet shell around a DPRNN or DPTNet core.  ``generator`` seeds the
    initial weights (none: seed 0); ``device`` places them."""

    def __init__(self, enc_dim=64, bn_dim=64, hidden_dim=128, win=16, layer=6, num_spk=2,
                 module="DPRNN", context_size=24, group_size=1, block_size=100,
                 sample_rate=16000, unfold=False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if module not in MODULES:
            raise NotImplementedError(f"TasNet module {module!r}: only {MODULES} are ported; "
                                      "the others are still to port (ROADMAP Queue 1)")
        if group_size != 1:
            raise NotImplementedError("TasNet group_size > 1 (group communication) is still to "
                                      "port (ROADMAP Queue 1)")
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
        kw = dict(input_size=bn_dim, hidden_size=hidden_dim, output_size=bn_dim, num_layers=layer,
                  unfold=unfold, device=device)
        core = DPRNNCore(**kw) if module == "DPRNN" else DPTNetCore(**kw)
        self.seq_model = _SeqModel(core)
        self.mask = nn.Sequential(nn.Conv1d(bn_dim, enc_dim * num_spk, 1, device=device))
        self.decoder = nn.ConvTranspose1d(enc_dim, 1, win, stride=stride, bias=False, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Seeded init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
        biases (U(-1/sqrt(H), 1/sqrt(H)) for the LSTMs, torch's default),
        unit norms, PReLU 0.25, unit gates."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if ("norm" in name or name.startswith("bottleneck.0")) and p.ndim == 1:
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif "concat_block" in name:
                    p.fill_(0.25 if ".1." in name else (1.0 if leaf == "weight" else 0.0))
                else:
                    if "_l0" in leaf:  # LSTM
                        bound = 1.0 / math.sqrt(self.hidden_dim)
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

        blocks, blk_rest = split_feature(feat, self.block_size)  # [B, bn, K, S]
        core = self.seq_model.seq_model(blocks).reshape(B, self.bn_dim, self.block_size, -1)
        fmap = merge_feature(core, blk_rest)  # [B, bn, T']

        conv = self.mask[0]
        m = torch.matmul(conv.weight[:, :, 0].to(fmap.dtype), fmap) + conv.bias.to(fmap.dtype)[:, None]
        m = torch.relu(m).reshape(B, self.num_spk, self.enc_dim, -1)
        masked = (m * enc[:, None]).reshape(B * self.num_spk, self.enc_dim, -1)

        dec = torch.matmul(masked.transpose(1, 2), self.decoder.weight[:, 0, :].to(masked.dtype))
        out = overlap_add(dec, stride)  # [B * spk, T + rest + 2 * stride]
        out = out[:, stride: out.shape[-1] - (rest + stride)]
        return restore_output(out.reshape(B, self.num_spk, -1), was_one_d)
