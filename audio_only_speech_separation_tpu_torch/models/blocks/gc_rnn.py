"""Group-communication RNN (counterpart of
``audio_only_speech_separation_tpu/models/blocks/gc_rnn.py``; reference
look2hear/models/utils/groupcomm.py:10-45): per layer a TAC across the
groups, then each group's sequence through a ``ProjRNN`` ((Bi)LSTM and a
Linear back), gLN (eps 1e-5) and a residual.  The LSTMs are the port's,
so they take K5 or K6 in bf16 on the card.  Keys: ``TAC.{i}``,
``rnn.{i}.{rnn, proj}`` and ``LN.{i}``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.norms import GlobalLayerNorm
from ...ops.rnn import ProjRNN
from .tac import TAC


class GC_RNN(nn.Module):
    """[B, dim, T] -> same shape; dim is split into ``num_group`` groups."""

    def __init__(self, input_size: int, hidden_size: int, num_group: int = 2, num_layers: int = 1,
                 bidirectional: bool = False, device=None):
        super().__init__()
        G = num_group
        n, h = input_size // G, hidden_size // G
        self.num_group = G
        self.TAC = nn.ModuleList([TAC(n, hidden_size * 3 // G, device=device) for _ in range(num_layers)])
        self.rnn = nn.ModuleList([ProjRNN(n, h, bidirectional, device=device) for _ in range(num_layers)])
        self.LN = nn.ModuleList([GlobalLayerNorm(n, eps=1e-5, channels_last=True, device=device)
                                 for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, dim, T = x.shape
        G = self.num_group
        n = dim // G
        out = x.reshape(B, G, n, T)
        for tac, rnn, norm in zip(self.TAC, self.rnn, self.LN):
            seq = tac(out).transpose(2, 3).reshape(B * G, T, n)
            seq = seq + norm(rnn(seq))
            out = seq.reshape(B, G, T, n).transpose(2, 3)
        return out.reshape(B, dim, T)
