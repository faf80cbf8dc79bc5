"""Dual-path transformer core (counterpart of
``audio_only_speech_separation_tpu/models/blocks/dptnet.py``; reference
look2hear/models/utils/dptnet.py).

DPTNet's transformer layer: 4-head self-attention, post-norm, then a
BiLSTM(d -> 2d) with relu and Linear(4d -> d) as the feed-forward
(dptnet.py:49-50,79), post-norm; LayerNorm eps 1e-5.  The layer sits at
``{row,col}_xfmr.{i}.transformer`` in look2hear's ``state_dict``, with
``self_attn.*``, ``norm1.*``, ``linear1.*`` (the BiLSTM), ``linear2.*`` and
``norm2.*``; ``unfold`` shares layer 0 and adds ``concat_block``.  With
``num_group`` G > 1 the layers are N/G wide on B*G rows and a TAC
(``TAC.{i}``) runs before each layer's row pass, as in ``DPRNNCore``.
Under an ``sp`` mesh the rows run on this rank's chunks and the columns on
its positions, as in ``DPRNNCore``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.attention import MultiheadAttention
from ...ops.rnn import BiLSTM
from ...parallel import sequence
from .dprnn import TAC, DepthwiseGate, _layers, core_output, group_exchange


class TransformerEncoderLayerDPT(nn.Module):
    """MHA + post-norm + BiLSTM feed-forward + post-norm on [B, T, d]."""

    def __init__(self, d_model: int, nhead: int = 4, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.linear1 = BiLSTM(d_model, 2 * d_model, device=device)
        self.linear2 = nn.Linear(4 * d_model, d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        # relu, then linear2, fused into the BiLSTM's output
        ffn = self.linear1(x, self.linear2.weight.t(), self.linear2.bias, torch.relu)
        return self.norm2(x + ffn)


class _SingleTransformer(nn.Module):
    """look2hear's wrapper: the layer under ``.transformer``."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.transformer = TransformerEncoderLayerDPT(d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.transformer(x)


class DPTNetCore(nn.Module):
    """The dual-path loop of ``DPRNNCore`` with transformer rows and
    columns: [B, N, K, S] -> [B, num_spk, output_size // num_spk, K, S],
    N split into ``num_group`` groups."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, num_group: int = 1,
                 num_layers: int = 1, unfold: bool = False, device=None):
        super().__init__()
        G = num_group
        n = input_size // G
        self.num_layers, self.unfold, self.num_group = num_layers, unfold, G
        self.num_spk = output_size // input_size
        if G > 1:
            self.TAC = nn.ModuleList([TAC(n, hidden_size * 3 // G, device=device) for _ in range(num_layers)])
        self.row_xfmr = _layers(lambda: _SingleTransformer(n, device=device), num_layers, unfold)
        self.col_xfmr = _layers(lambda: _SingleTransformer(n, device=device), num_layers, unfold)
        if unfold:
            self.concat_block = DepthwiseGate(n, device=device)
        self.output = nn.Conv2d(n, output_size // G, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        G = self.num_group
        B, n, K, S = x.shape[0] * G, x.shape[1] // G, x.shape[2], x.shape[3]  # each group a batch row
        # rows on this rank's chunks S (all of them off an sp mesh)
        cur = sequence.shard(x.reshape(B, n, K, S).permute(0, 3, 2, 1), 1)  # [B*G, S, K, n]: rows
        for i in range(self.num_layers):
            j = 0 if self.unfold else i
            if G > 1:
                cur = group_exchange(self.TAC[i], cur, G)
            row = self.row_xfmr[j](cur.reshape(-1, K, n)).reshape(cur.shape)
            cur = sequence.exchange((cur + row).transpose(1, 2), 1, 2, S)  # [B, K, S, n]: columns
            col = self.col_xfmr[j](cur.reshape(-1, S, n)).reshape(cur.shape)
            cur = cur + col
            if self.unfold:
                cur = self.concat_block(cur)
            if i + 1 < self.num_layers:
                cur = sequence.exchange(cur, 2, 1, K).transpose(1, 2)
        return core_output(sequence.gather(cur, 1, K), self.output, self.num_spk, G)
