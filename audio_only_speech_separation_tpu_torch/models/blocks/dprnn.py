"""Dual-path RNN core (counterpart of
``audio_only_speech_separation_tpu/models/blocks/dprnn.py``; reference
look2hear/models/utils/dprnn.py:6-88).

Per layer: the intra-chunk (row) BiLSTM over the chunk axis K, batched over
B*S chunks, plus gLN and a residual; then the inter-chunk (column) BiLSTM
over the chunk index S, batched over B*K positions, plus gLN and a
residual.  ``unfold=True`` shares one row and one column RNN across the
layers and gates each layer's output with a depthwise 1x1 ``concat_block``
(dprnn.py:26-34,82).  Rows run on [B, S, K, n] and columns on [B, K, S, n]
(channels last), one K<->S swap between passes.

The ``state_dict`` keys are look2hear's: ``row_rnn.{i}.{rnn,proj}.*``,
``col_rnn.{i}.*``, ``row_norm.{i}.*``, ``col_norm.{i}.*`` (i = 0 only with
unfold, plus ``concat_block.{0,1}.*``) and ``output.{weight [out, n, 1, 1],
bias}``.  With ``num_group`` G > 1 the channels split into G groups of
n = N/G, each run as its own batch row (B*G), and a TAC (``TAC.{i}``)
exchanges across the groups before each layer's row pass; the LSTMs are
then hidden_size/G wide.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import PReLU
from ...ops.norms import GlobalLayerNorm
from ...ops.rnn import ProjRNN
from ...parallel import sequence
from .tac import TAC


class _ChannelScale(nn.Module):
    """The depthwise 1x1 conv of ``concat_block``: weight [C, 1, 1, 1] (a
    Conv2d; [C, 1, 1] for a Conv1d, ``conv_dims=1``), bias [C], applied on
    the last axis."""

    def __init__(self, channels: int, conv_dims: int = 2, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones((channels, 1) + (1,) * conv_dims, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.reshape(-1).to(x.dtype) + self.bias.to(x.dtype)


class DepthwiseGate(nn.Sequential):
    """Depthwise 1x1 conv + PReLU on channels-last [..., C] (the unfold
    ``concat_block``: keys ``0.weight``, ``0.bias``, ``1.weight``); a
    Conv2d's weight layout, or with ``conv_dims=1`` a Conv1d's (TDANet,
    AFRCNN)."""

    def __init__(self, channels: int, conv_dims: int = 2, device=None):
        super().__init__(_ChannelScale(channels, conv_dims, device=device), PReLU(device=device))


def _layers(make, n: int, shared: bool) -> nn.ModuleList:
    return nn.ModuleList([make() for _ in range(1 if shared else n)])


def core_output(cur: torch.Tensor, output: nn.Conv2d, num_spk: int, G: int = 1) -> torch.Tensor:
    """The 1x1 Conv2d over channels, per group: [B*G, K, S, n] -> [B, num_spk,
    G * out/num_spk, K, S] (the groups inside each speaker's channels)."""
    BG, K, S, _ = cur.shape
    w = output.weight[:, :, 0, 0].to(cur.dtype)  # [out, n]
    y = torch.einsum("bksc,dc->bdks", cur, w) + output.bias.to(cur.dtype)[None, :, None, None]
    y = y.reshape(BG // G, G, num_spk, -1, K, S).transpose(1, 2)
    return y.reshape(BG // G, num_spk, -1, K, S)


def group_exchange(tac: TAC, cur: torch.Tensor, G: int) -> torch.Tensor:
    """``tac`` across the groups of the row layout [B*G, S, K, n], on the
    reference's [B, G, n, K*S]."""
    BG, S, K, n = cur.shape
    tmp = tac(cur.permute(0, 3, 2, 1).reshape(BG // G, G, n, K * S))
    return tmp.reshape(BG, n, K, S).permute(0, 3, 2, 1)


class DPRNNCore(nn.Module):
    """[B, N, K, S] -> [B, num_spk, output_size // num_spk, K, S], with
    num_spk = output_size // input_size and N split into ``num_group``
    groups."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, num_group: int = 1,
                 num_layers: int = 1, bidirectional: bool = True, unfold: bool = False, device=None):
        super().__init__()
        G = num_group
        n, h = input_size // G, hidden_size // G
        self.num_layers, self.unfold, self.num_group = num_layers, unfold, G
        self.num_spk = output_size // input_size
        if G > 1:
            self.TAC = nn.ModuleList([TAC(n, hidden_size * 3 // G, device=device) for _ in range(num_layers)])
        self.row_rnn = _layers(lambda: ProjRNN(n, h, True, device=device), num_layers, unfold)
        self.col_rnn = _layers(lambda: ProjRNN(n, h, bidirectional, device=device), num_layers, unfold)
        self.row_norm = _layers(lambda: GlobalLayerNorm(n, 1e-8, channels_last=True, device=device),
                                num_layers, unfold)
        self.col_norm = _layers(lambda: GlobalLayerNorm(n, 1e-8, channels_last=True, device=device),
                                num_layers, unfold)
        if unfold:
            self.concat_block = DepthwiseGate(n, device=device)
        self.output = nn.Conv2d(n, output_size // G, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        G = self.num_group
        B, n, K, S = x.shape[0] * G, x.shape[1] // G, x.shape[2], x.shape[3]  # each group a batch row
        group = sequence.sp_group()
        # rows on this rank's chunks S (all of them off an sp mesh)
        cur = sequence.shard(x.reshape(B, n, K, S).permute(0, 3, 2, 1), 1)  # [B*G, S, K, n]: rows
        for i in range(self.num_layers):
            j = 0 if self.unfold else i
            if G > 1:
                cur = group_exchange(self.TAC[i], cur, G)
            row_out = self.row_rnn[j](cur.reshape(-1, K, n)).reshape(cur.shape)
            cur = (cur + self.row_norm[j](row_out, group)).transpose(1, 2)  # [B, K, S, n]
            cur = sequence.exchange(cur, 1, 2, S)  # columns on this rank's positions K
            col_out = self.col_rnn[j](cur.reshape(-1, S, n)).reshape(cur.shape)
            cur = cur + self.col_norm[j](col_out, group)
            if self.unfold:
                cur = self.concat_block(cur)
            if i + 1 < self.num_layers:
                cur = sequence.exchange(cur, 2, 1, K).transpose(1, 2)
        return core_output(sequence.gather(cur, 1, K), self.output, self.num_spk, G)
