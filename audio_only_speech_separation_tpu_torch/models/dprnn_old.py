"""DPRNNTasNet, the legacy DPRNN separation model (counterpart of
``audio_only_speech_separation_tpu/models/dprnn_old.py``; reference
look2hear/models/dprnn_old.py:400-516).

A learned filterbank of win ms with stride win/4, padded by a window (the
ConvTasNet pad quirk), gLN with float32 eps, a bias-free 1x1 bottleneck,
50%-overlap chunking, the dual-path core ``OldDPRNN`` (no TAC), the merge
as the mask (no activation), and the transposed filterbank.  ``OldDPRNN``
runs rows and columns channels-last like ``blocks.DPRNNCore``: each pass a
``ProjRNN`` ((Bi)LSTM, then a Linear back to N), a norm and a residual;
with ``full_causal`` the rows and columns run one-direction LSTMs and cLN
(over the flattened chunk axes, as the reference does).  The LSTMs take
K6 at the defaults' shapes in bf16 on the card (``ops/rnn.py::kernel_choice``:
the rows are 32 steps, the columns more than 16 sequences at B=1).

The ``state_dict`` uses look2hear's keys (the JAX package's
``utils/torch_import.py::convert_dprnn_tasnet``): ``encoder._filters``,
``freq_norm``, ``freq_separator.BN.weight`` [F, basis, 1],
``freq_separator.DPRNN.{row_rnn, col_rnn}.{i}.{rnn, proj}``,
``freq_separator.DPRNN.{row_norm, col_norm}.{i}``,
``freq_separator.DPRNN.output.{weight [out, N, 1, 1], bias}`` and
``decoder._filters``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.chunk import merge_feature, split_feature
from ..ops.conv import ConvDecoder, ConvEncoder
from ..ops.norms import CumulativeLayerNorm, GlobalLayerNorm
from ..ops.rnn import ProjRNN
from . import register_model
from .base import BaseModel, seeded_init_

_F32_EPS = float(np.finfo(np.float32).eps)

# (Bi)LSTM + Linear proj (reference dprnn_old.py:57-95), the JAX package's
# ``SingleRNNProj``: the one module, with the ``rnn.*`` / ``proj.*``
# parameter names look2hear checkpoints load with.
SingleRNNProj = ProjRNN


class OldDPRNN(nn.Module):
    """Dual-path core without TAC (dprnn_old.py:99-196): [B, N, K, S] ->
    [B, output_size, K, S]."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, num_layers: int = 1,
                 bidirectional: bool = True, full_causal: bool = False, device=None):
        super().__init__()
        n = input_size
        self.num_layers, self.full_causal = num_layers, full_causal
        self.col_bi = bidirectional and not full_causal

        def norm(causal):
            return CumulativeLayerNorm(n, 1e-8, device=device) if causal else \
                GlobalLayerNorm(n, 1e-8, channels_last=True, device=device)

        self.row_rnn = nn.ModuleList([SingleRNNProj(n, hidden_size, not full_causal, device=device)
                                      for _ in range(num_layers)])
        self.col_rnn = nn.ModuleList([SingleRNNProj(n, hidden_size, self.col_bi, device=device)
                                      for _ in range(num_layers)])
        self.row_norm = nn.ModuleList([norm(full_causal) for _ in range(num_layers)])
        self.col_norm = nn.ModuleList([norm(not self.col_bi) for _ in range(num_layers)])
        self.output = nn.Conv2d(n, output_size, 1, device=device)

    @staticmethod
    def _norm(norm: nn.Module, y: torch.Tensor, rows: bool) -> torch.Tensor:
        """``norm`` on y ([B, S, K, n] rows or [B, K, S, n] columns): gLN
        channels-last, or cLN over the (K, S) positions in K-major order,
        the reference's [B, n, K*S]."""
        if isinstance(norm, GlobalLayerNorm):
            return norm(y)
        B, A1, A2, n = y.shape
        kmajor = y.permute(0, 3, 2, 1) if rows else y.permute(0, 3, 1, 2)  # [B, n, K, S]
        out = norm(kmajor.reshape(B, n, A1 * A2)).reshape(B, n, *kmajor.shape[2:])
        return out.permute(0, 3, 2, 1) if rows else out.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, n, K, S = x.shape
        cur = x.permute(0, 3, 2, 1)  # [B, S, K, n]: rows
        for i in range(self.num_layers):
            row = self.row_rnn[i](cur.reshape(B * S, K, n)).reshape(B, S, K, n)
            cur = (cur + self._norm(self.row_norm[i], row, True)).transpose(1, 2)  # [B, K, S, n]
            col = self.col_rnn[i](cur.reshape(B * K, S, n)).reshape(B, K, S, n)
            cur = cur + self._norm(self.col_norm[i], col, False)
            if i + 1 < self.num_layers:
                cur = cur.transpose(1, 2)
        w = self.output.weight[:, :, 0, 0].to(cur.dtype)  # [out, n]
        return torch.einsum("bksc,dc->bdks", cur, w) + self.output.bias.to(cur.dtype)[None, :, None, None]


class _FreqSeparator(nn.Module):
    """look2hear's ``freq_separator``: the bottleneck ``BN`` and ``DPRNN``."""

    def __init__(self, basis: int, feature_dim: int, hidden_dim: int, num_spk: int, layer: int,
                 bidirectional: bool, device=None):
        super().__init__()
        self.BN = nn.Conv1d(basis, feature_dim, 1, bias=False, device=device)
        self.DPRNN = OldDPRNN(feature_dim, hidden_dim, basis * num_spk, num_layers=layer,
                              bidirectional=bidirectional, device=device)


@register_model
class DPRNNTasNet(BaseModel):
    """DPRNNTasNet with the JAX model's arguments (``win`` in ms).
    ``generator`` seeds the initial weights (none: seed 0); ``device``
    places them."""

    def __init__(self, feature_dim=128, hidden_dim=256, sample_rate=16000, win=4, layer=6,
                 segment_size=32, context=1, num_spk=2, bidirectional=True, rnn_type="LSTM",
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.feature_dim, self.hidden_dim, self.sample_rate, self.win = feature_dim, hidden_dim, sample_rate, win
        self.layer, self.segment_size, self.context, self.num_spk = layer, segment_size, context, num_spk
        self.bidirectional, self.rnn_type = bidirectional, rnn_type
        self.freq_win = sample_rate * win // 1000
        self.freq_stride = self.freq_win // 4
        self.basis = self.freq_win // 2 + 1
        self.encoder = ConvEncoder(self.basis, self.freq_win, self.freq_stride, device=device)
        self.freq_norm = GlobalLayerNorm(self.basis, eps=_F32_EPS, device=device)
        self.freq_separator = _FreqSeparator(self.basis, feature_dim, hidden_dim, num_spk, layer,
                                             bidirectional, device=device)
        self.decoder = ConvDecoder(self.basis, self.freq_win, self.freq_stride, device=device)
        seeded_init_(self, generator)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        was_one_d = wav.ndim == 1
        x = wav[None] if was_one_d else (wav[:, 0] if wav.ndim == 3 else wav)
        B, T = x.shape
        win, stride = self.freq_win, self.freq_stride
        rest = win - (stride + T % win) % win
        x = F.pad(x, (win - stride, win - stride + rest))

        mixture_w = self.encoder(x)  # [B, basis, T']
        normed = self.freq_norm(mixture_w)
        bn = self.freq_separator.BN.weight[:, :, 0].to(normed.dtype)
        chunks, chunk_rest = split_feature(torch.matmul(bn, normed), self.segment_size)
        out = self.freq_separator.DPRNN(chunks)  # [B, basis * spk, K, S]
        out = out.reshape(B * self.num_spk, self.basis, self.segment_size, -1)
        mask = merge_feature(out, chunk_rest).reshape(B, self.num_spk, self.basis, -1)

        est = (mask * mixture_w[:, None]).reshape(B * self.num_spk, self.basis, -1)
        dec = self.decoder(est).reshape(B, self.num_spk, -1)
        crop = win - stride
        dec = dec[:, :, crop: dec.shape[-1] - (rest + crop)]
        return dec[0] if was_one_d else dec
