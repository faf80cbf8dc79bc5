"""Transform-average-concatenate (TAC), the group-communication block
(counterpart of ``audio_only_speech_separation_tpu/models/blocks/tac.py``;
reference look2hear/models/utils/gc3_basics.py:28-60).

Each group's channels go through a Linear + PReLU; their mean over the
groups through another; the two are concatenated and mapped back by a
third, then gLN (eps 1e-5) per (batch, group) and a residual.  The three
Linears are library matmuls.  Keys: ``TAC_input.{0,1}``,
``TAC_mean.{0,1}``, ``TAC_output.{0,1}`` and ``TAC_norm``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.activations import PReLU
from ...ops.norms import GlobalLayerNorm


class TAC(nn.Module):
    """[B, G, N, T] -> same shape, the groups exchanged through their mean."""

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.TAC_input = nn.Sequential(nn.Linear(input_size, hidden_size, device=device), PReLU(device=device))
        self.TAC_mean = nn.Sequential(nn.Linear(hidden_size, hidden_size, device=device), PReLU(device=device))
        self.TAC_output = nn.Sequential(nn.Linear(2 * hidden_size, input_size, device=device),
                                        PReLU(device=device))
        self.TAC_norm = GlobalLayerNorm(input_size, eps=1e-5, channels_last=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, G, N, T = x.shape
        h = self.TAC_input(x.permute(0, 3, 1, 2))  # [B, T, G, H]
        mean = self.TAC_mean(h.mean(dim=2))  # [B, T, H]
        cat = torch.cat([h, mean[:, :, None].expand_as(h)], dim=-1)
        out = self.TAC_output(cat).transpose(1, 2).reshape(B * G, T, N)  # [B*G, T, N]
        out = self.TAC_norm(out).reshape(B, G, T, N).transpose(2, 3)
        return x + out
