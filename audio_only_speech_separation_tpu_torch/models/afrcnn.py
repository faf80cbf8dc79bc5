"""A-FRCNN, the fully recurrent multi-scale fusion network (counterpart of
``audio_only_speech_separation_tpu/models/afrcnn.py``; reference
afrcnn.py:246-364), channels-last [B, T, C] throughout.

The shell (encoder, gLN, bottleneck, masks, decoder) is TDANet's
(``tdanet.MaskedFilterbank``); the separator iterates one weight-shared
``FRCNNBlock`` ``num_blocks`` times with the input re-injected through a
depthwise gate.  A block: a 1x1 up to ``in_channels``, a pyramid of
depthwise convs (stride 2 below the top), each scale fused with its
neighbours (the finer one downsampled by a stride-2 depthwise conv, the
coarser one upsampled, nearest) by a 1x1, all scales upsampled to the top
and fused by a last 1x1, then a 1x1 residual.  It runs no kernel: in bf16
on the card it is the module cast to bf16.

The ``state_dict`` uses look2hear's keys: ``sm.blocks.{proj_1x1,
spp_dw.{k}, fuse_layers.{i}.0, concat_layer.{i}, last_layer.0, res_conv}``,
``sm.concat_block.{0,1}`` and the shell's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import conv1d_channels_last
from ..ops.resample import interpolate_nearest
from . import register_model
from .base import seeded_init_
from .blocks.dprnn import DepthwiseGate
from .blocks.sudo import ConvNormAct, DilatedConvNorm
from .tdanet import MaskedFilterbank


class FRCNNBlock(nn.Module):
    """One A-FRCNN block (afrcnn.py:154-224), [B, T, out_channels] -> same."""

    def __init__(self, out_channels: int = 128, in_channels: int = 512, upsampling_depth: int = 4,
                 device=None):
        super().__init__()
        C, D = in_channels, upsampling_depth
        self.depth = D
        self.proj_1x1 = ConvNormAct(out_channels, C, 1, device=device)

        def down():
            return DilatedConvNorm(C, C, 5, stride=2, groups=C, device=device)

        self.spp_dw = nn.ModuleList([DilatedConvNorm(C, C, 5, stride=1, groups=C, device=device)]
                                    + [down() for _ in range(1, D)])
        self.fuse_layers = nn.ModuleList([nn.ModuleList([down()] if i > 0 else [])
                                          for i in range(D)])
        self.concat_layer = nn.ModuleList([
            ConvNormAct(C * (2 if i in (0, D - 1) else 3), C, 1, device=device) for i in range(D)])
        self.last_layer = nn.Sequential(ConvNormAct(C * D, C, 1, device=device))
        self.res_conv = nn.Conv1d(C, out_channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scales = [self.spp_dw[0](self.proj_1x1(x))]
        for conv in self.spp_dw[1:]:
            scales.append(conv(scales[-1]))
        fused = []
        for i in range(self.depth):
            T_i = scales[i].shape[1]
            parts = [self.fuse_layers[i][0](scales[i - 1])] if i > 0 else []
            parts.append(scales[i])
            if i + 1 < self.depth:
                parts.append(interpolate_nearest(scales[i + 1], T_i, dim=1))
            fused.append(self.concat_layer[i](torch.cat(parts, dim=-1)))
        T0 = scales[0].shape[1]
        fused = [fused[0]] + [interpolate_nearest(f, T0, dim=1) for f in fused[1:]]
        concat = self.last_layer(torch.cat(fused, dim=-1))
        return conv1d_channels_last(self.res_conv, concat) + x


class RecurrentA(nn.Module):
    """``iters`` applications of one block with the input re-injected
    through a depthwise gate (afrcnn.py:227-243)."""

    def __init__(self, out_channels: int, in_channels: int, upsampling_depth: int, iters: int,
                 device=None):
        super().__init__()
        self.iters = iters
        self.blocks = FRCNNBlock(out_channels, in_channels, upsampling_depth, device=device)
        self.concat_block = DepthwiseGate(out_channels, conv_dims=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mixture = x
        for i in range(self.iters):
            x = self.blocks(x if i == 0 else self.concat_block(mixture + x))
        return x


@register_model
class AFRCNN(MaskedFilterbank):
    """A-FRCNN with the arguments of ``configs/afrcnn_lrs2.yml``'s
    ``audionet_config``.  ``generator`` seeds the initial weights (none:
    seed 0); ``device`` places them."""

    def __init__(self, out_channels=512, in_channels=512, num_blocks=16, upsampling_depth=5,
                 enc_kernel_size=1, num_sources=2, sample_rate=16000, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.out_channels, self.in_channels, self.num_blocks = out_channels, in_channels, num_blocks
        self.upsampling_depth, self.enc_kernel_size = upsampling_depth, enc_kernel_size
        self.num_sources, self.sample_rate = num_sources, sample_rate
        self._build_shell(device)
        self.sm = RecurrentA(out_channels, in_channels, upsampling_depth, num_blocks, device)
        seeded_init_(self, generator)
