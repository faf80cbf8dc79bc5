"""BSRNN, the band-split RNN in the STFT domain (counterpart of
``audio_only_speech_separation_tpu/models/bsrnn.py``; reference
look2hear/models/bsrnn.py).

Forward: a Hann STFT (float32 whatever the input dtype) -> the spectrum cut
into the bands of ``compute_band_widths`` -> per band a gLN and a 1x1 to
``feature_dim`` -> ``num_repeat`` BSNets, each a residual BiLSTM over time
per band (``band_rnn``) then one across the bands per frame
(``band_comm``) -> per band a gated complex mask MLP (with ``context``
frames either side) -> mask x spectrum -> the inverse STFT.

As in the JAX package, the per-band bottleneck and mask heads run
band-batched: the bands zero-padded to the widest and stacked, one masked
gLN (its statistics divided by each band's true element count) and one
batched product per layer.  The padded stacks are built from the per-band
parameters at every call, so a bf16 copy of the module keeps nothing
stale.  The spectrum, the window and the complex mask product stay float32;
the separator body runs in the input dtype, each product accumulated in
float32 and rounded once.

The LSTMs are the port's (``ops/rnn.py``): in bf16 on the card the band
RNN (B*nband sequences of T frames) takes the recurrence kernel K5 and the
band-comm RNN (B*T sequences of nband bands) the resident kernel K6.

The ``state_dict`` uses look2hear's keys: ``BN.{i}.{0,1}``,
``separator.{r}.band_rnn.{j}.{norm,rnn,proj}``,
``separator.{r}.band_comm.{norm,rnn,proj}`` and ``mask.{i}.{0,1,3,5,6,7}``.
Under a mesh with an ``sp`` axis (``parallel/sequence.py``; the JAX
package's band-axis ``shard_chunks``) each rank runs the band RNNs on its
share of the bands and the band-comm RNN on its share of the frames, with
an exchange between them, and one gather after the separator.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import PReLU
from ..ops.dropout import Dropout
from ..ops.norms import GlobalLayerNorm
from ..ops.rnn import BiLSTM, LSTM
from ..ops.stft import hann_window, istft, stft
from ..parallel import sequence
from . import register_model
from .base import BaseModel, normalize_input, restore_output, seeded_init_

_F32_EPS = float(np.finfo(np.float32).eps)


def compute_band_widths(sample_rate: int, enc_dim: int) -> List[int]:
    """Band partition (reference bsrnn.py:93-121): 100 Hz bands at the
    bottom, then 250/500/1k/2k, with a final remainder band."""
    half = sample_rate / 2.0
    bw: List[int] = []
    b100 = int(math.floor(100 / half * enc_dim))
    bw += [b100] * int(math.ceil(10 / 44100 * sample_rate))
    b250 = int(math.floor(250 / half * enc_dim))
    m = int(math.ceil(12 / 44100 * sample_rate))
    if sum(bw + [b250] * m) < enc_dim:
        bw += [b250] * m
    b500 = int(math.floor(500 / half * enc_dim))
    m = int(math.ceil(8 / 44100 * sample_rate))
    if sum(bw + [b500] * m) < enc_dim:
        bw += [b500] * m
    if sample_rate > 8000:
        b1k = int(math.floor(1000 / half * enc_dim))
        m = int(math.ceil(8 / 44100 * sample_rate))
        if sum(bw + [b1k] * m) < enc_dim:
            bw += [b1k] * m
    if sample_rate > 16000:
        b2k = int(math.floor(2000 / half * enc_dim))
        m = int(math.ceil(2 / 44100 * sample_rate))
        if sum(bw + [b2k] * m) < enc_dim:
            bw += [b2k] * m
    bw.append(enc_dim - sum(bw))
    assert bw[-1] > 0, f"{enc_dim}, {sum(bw)}"
    return bw


class ResRNN(nn.Module):
    """gLN (float32 eps) -> dropout -> (Bi)LSTM -> Linear, residual, on
    [B, D, T] (reference bsrnn.py:13-34)."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.bidirectional = bidirectional
        self.norm = GlobalLayerNorm(input_size, eps=_F32_EPS, device=device)
        self.dropout = Dropout(dropout)
        self.rnn = (BiLSTM if bidirectional else LSTM)(input_size, hidden_size, device=device)
        self.proj = nn.Linear(hidden_size * (2 if bidirectional else 1), input_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(self.norm(x)).transpose(1, 2)  # [B, T, D]
        if self.bidirectional:
            h = self.rnn(h, self.proj.weight.t(), self.proj.bias)
        else:
            h = self.proj(self.rnn(h))
        return x + h.transpose(1, 2)


class BSNet(nn.Module):
    """Per-band time RNNs, then the cross-band RNN (reference
    bsrnn.py:37-60), on [B, nband * N, T]."""

    def __init__(self, nband: int, feature_dim: int, num_layer: int = 1, bi_comm: bool = True,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.nband, self.feature_dim = nband, feature_dim
        N = feature_dim
        self.band_rnn = nn.ModuleList([ResRNN(N, 2 * N, dropout=dropout, device=device)
                                       for _ in range(num_layer)])
        self.band_comm = ResRNN(N, 2 * N, bidirectional=bi_comm, dropout=dropout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, nb * N, T] -> the same: every band, or under an ``sp`` mesh
        this rank's share of the bands."""
        B, _, T = x.shape
        N, nband = self.feature_dim, self.nband
        h = x.reshape(-1, N, T)  # [B * nb, N, T]
        for layer in self.band_rnn:
            h = layer(h)
        # band comm: sequences along the band axis, batched over B*T (this rank's frames under sp)
        h = sequence.exchange(h.reshape(B, -1, N, T), 3, 1, nband)  # [B, nband, N, T_r]
        T_r = h.shape[3]
        h = self.band_comm(h.permute(0, 3, 2, 1).reshape(B * T_r, N, nband))
        h = sequence.exchange(h.reshape(B, T_r, N, nband).permute(0, 3, 2, 1), 1, 3, T)
        return h.reshape(B, -1, T)


def _pad_rows(p: torch.Tensor, bwi: int, bw_max: int) -> torch.Tensor:
    """[2*bwi, ...] -> [2*bw_max, ...]: the (real, imag) row halves each
    zero-padded to bw_max rows."""
    p = p.reshape((2, bwi) + p.shape[1:])
    p = F.pad(p, (0, 0) * (p.ndim - 2) + (0, bw_max - bwi))
    return p.reshape((2 * bw_max,) + p.shape[2:])


@lru_cache(maxsize=8)
def _band_widths_on(band_width: tuple, device: torch.device) -> torch.Tensor:
    """The band widths as a float32 tensor on ``device``, copied there once
    (a copy inside the forward would wait for the device's queue)."""
    return torch.tensor(band_width, dtype=torch.float32, device=device)


def _band_conv(h: torch.Tensor, kernels: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """Per-band 1x1: [B, k, c, T] x [k, c, d] -> [B, k, d, T] in h's dtype,
    plus the bias [k, d]."""
    y = torch.einsum("bkct,kcd->bkdt", h, kernels.to(h.dtype))
    return y + biases.to(y.dtype)[None, :, :, None]


@register_model
class BSRNN(BaseModel):
    """BSRNN with the arguments of ``configs/bsrnn_wsj0.yml``'s
    ``audionet_config``; ``sample_rate`` sets the bands.  ``generator``
    seeds the initial weights (none: seed 0); ``device`` places them."""

    def __init__(self, win=256, stride=64, feature_dim=128, num_spks=2, num_layer=1, num_repeat=8,
                 context=0, dropout=0.0, bi_comm=True, sample_rate=16000, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.win, self.stride, self.feature_dim, self.num_spks = win, stride, feature_dim, num_spks
        self.num_layer, self.num_repeat, self.context, self.dropout = num_layer, num_repeat, context, dropout
        self.bi_comm, self.sample_rate = bi_comm, sample_rate
        self.enc_dim = win // 2 + 1
        self.band_width = compute_band_widths(sample_rate, self.enc_dim)
        self.nband = len(self.band_width)
        N, ratio = feature_dim, 2 * context + 1
        self.BN = nn.ModuleList([
            nn.Sequential(GlobalLayerNorm(2 * bw, eps=_F32_EPS, device=device),
                          nn.Conv1d(2 * bw, N, 1, device=device))
            for bw in self.band_width])
        self.separator = nn.ModuleList([BSNet(self.nband, N, num_layer, bi_comm, dropout, device)
                                        for _ in range(num_repeat)])
        self.mask = nn.ModuleList([
            nn.Sequential(GlobalLayerNorm(N, eps=_F32_EPS, device=device),
                          nn.Conv1d(N, 4 * N, 1, device=device), nn.Tanh(),
                          nn.Conv1d(4 * N, 4 * N, 1, device=device), nn.Tanh(),
                          nn.Conv1d(4 * N, 4 * bw * ratio, 1, device=device), PReLU(device=device),
                          nn.Conv1d(4 * bw * ratio, 4 * num_spks * ratio * bw, 1, device=device))
            for bw in self.band_width])
        seeded_init_(self, generator)

    def _bottleneck_params(self):
        """The per-band gLN affines and 1x1s, padded to bw_max and stacked:
        gamma, beta [nband, 2*bw_max], kernel [nband, 2*bw_max, N], bias
        [nband, N]."""
        bw_max = max(self.band_width)
        gammas, betas, kerns, biases = [], [], [], []
        for seq, bw in zip(self.BN, self.band_width):
            norm, conv = seq[0], seq[1]
            gammas.append(_pad_rows(norm.weight, bw, bw_max))
            betas.append(_pad_rows(norm.bias, bw, bw_max))
            kerns.append(_pad_rows(conv.weight[:, :, 0].t(), bw, bw_max))
            biases.append(conv.bias)
        return torch.stack(gammas), torch.stack(betas), torch.stack(kerns), torch.stack(biases)

    def _mask_params(self):
        """The per-band mask heads stacked: the gLN affines, the 1x1s c1-c4
        as [nband, in, out] kernels and [nband, out] biases (c3's columns
        and c4's rows zero-padded, c4's columns scattered into the padded
        (2, 2, spk, ratio, bw_max) layout), the PReLU slopes [nband]."""
        bw_max = max(self.band_width)
        ratio, spk = 2 * self.context + 1, self.num_spks
        d3max = 4 * bw_max * ratio
        out = {k: [] for k in ("g", "b", "k1", "b1", "k2", "b2", "k3", "b3", "a", "k4", "b4")}
        for head, bw in zip(self.mask, self.band_width):
            d3 = 4 * bw * ratio
            out["g"].append(head[0].weight)
            out["b"].append(head[0].bias)
            for j, i in ((1, 1), (2, 3)):
                out[f"k{j}"].append(head[i].weight[:, :, 0].t())
                out[f"b{j}"].append(head[i].bias)
            out["k3"].append(F.pad(head[5].weight[:, :, 0].t(), (0, d3max - d3)))
            out["b3"].append(F.pad(head[5].bias, (0, d3max - d3)))
            out["a"].append(head[6].weight[0])
            k4 = head[7].weight[:, :, 0].t().reshape(d3, 2, 2, spk, ratio, bw)
            out["k4"].append(F.pad(k4, (0, bw_max - bw) + (0, 0) * 4 + (0, d3max - d3)).reshape(d3max, -1))
            b4 = head[7].bias.reshape(2, 2, spk, ratio, bw)
            out["b4"].append(F.pad(b4, (0, bw_max - bw)).reshape(-1))
        return {k: torch.stack(v) for k, v in out.items()}

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        wav, was_one_d = normalize_input(wav)
        in_dtype = wav.dtype
        B, nsample = wav.shape
        x = wav.float()  # the STFT runs in float32 whatever the body's dtype
        band_width, nband, N = self.band_width, self.nband, self.feature_dim
        bw_max, ratio, spk = max(band_width), 2 * self.context + 1, self.num_spks
        window = hann_window(self.win, torch.float32, x.device)

        spec = stft(x, self.win, self.stride, window)  # [B, F, T] complex
        T = spec.shape[-1]
        if self.context > 0:  # context stack [B, K, F, T]
            c = self.context
            ctx = [F.pad(spec[:, :-i], (0, 0, i, 0)) for i in range(c, 0, -1)] + [spec]
            ctx += [F.pad(spec[:, i:], (0, 0, 0, i)) for i in range(1, c + 1)]
            mixture_context = torch.stack(ctx, dim=1)
        else:
            mixture_context = spec[:, None]
        spec_ri = torch.stack([spec.real, spec.imag], dim=1)  # [B, 2, F, T]

        # band-batched bottleneck: bands zero-padded to bw_max and stacked
        subs, ctxs, idx = [], [], 0
        for bw in band_width:
            subs.append(F.pad(spec_ri[:, :, idx: idx + bw], (0, 0, 0, bw_max - bw)))
            ctxs.append(F.pad(mixture_context[:, :, idx: idx + bw], (0, 0, 0, bw_max - bw)))
            idx += bw
        sub_stack = torch.stack(subs, dim=1)  # [B, nband, 2, bw_max, T]
        ctx_stack = torch.stack(ctxs, dim=1)  # [B, nband, K, bw_max, T] complex
        flat = sub_stack.reshape(B, nband, 2 * bw_max, T).to(in_dtype)

        gamma, beta, kern, bias = self._bottleneck_params()
        # masked gLN statistics: padded entries are zero, so the sums are
        # exact; each band divides by its true element count
        cnt = _band_widths_on(tuple(band_width), x.device) * (2 * T)
        f32 = flat.float()
        mean = f32.sum(dim=(2, 3)) / cnt  # [B, nband]
        var = torch.clamp(f32.square().sum(dim=(2, 3)) / cnt - mean.square(), min=0.0)
        norm = ((f32 - mean[..., None, None]) / torch.sqrt(var + _F32_EPS)[..., None, None]).to(flat.dtype)
        # the padded gamma rows are zero, so the padded rows of h are zero
        h = norm * gamma[None, :, :, None].to(flat.dtype) + beta[None, :, :, None].to(flat.dtype)
        sep = sequence.shard(_band_conv(h, kern, bias), 1).reshape(B, -1, T)  # this rank's bands under sp

        for bsnet in self.separator:
            sep = bsnet(sep)
        sep = sequence.gather(sep.reshape(B, -1, N, T), 1, nband)

        # band-batched gated complex mask heads
        p = self._mask_params()
        hm = sep.float()
        mean = hm.mean(dim=(2, 3), keepdim=True)
        var = (hm - mean).square().mean(dim=(2, 3), keepdim=True)
        hm = ((hm - mean) / torch.sqrt(var + _F32_EPS)).to(sep.dtype)
        hm = hm * p["g"][None, :, :, None].to(hm.dtype) + p["b"][None, :, :, None].to(hm.dtype)
        hm = torch.tanh(_band_conv(hm, p["k1"], p["b1"]))
        hm = torch.tanh(_band_conv(hm, p["k2"], p["b2"]))
        h3 = _band_conv(hm, p["k3"], p["b3"])
        h3 = torch.where(h3 >= 0, h3, p["a"][None, :, None, None].to(h3.dtype) * h3)
        h4 = _band_conv(h3, p["k4"], p["b4"]).reshape(B, nband, 2, 2, spk, ratio, bw_max, T)
        mask = h4[:, :, 0] * torch.sigmoid(h4[:, :, 1])
        m_re, m_im = mask[:, :, 0], mask[:, :, 1]  # [B, nband, spk, K, bw_max, T]
        # the mask in the body's dtype times the float32 context: float32
        ctx_re, ctx_im = ctx_stack.real[:, :, None], ctx_stack.imag[:, :, None]
        est_re = (ctx_re * m_re).mean(dim=3) - (ctx_im * m_im).mean(dim=3)
        est_im = (ctx_re * m_im).mean(dim=3) + (ctx_im * m_re).mean(dim=3)
        est = torch.complex(est_re, est_im)  # [B, nband, spk, bw_max, T]
        est_spec = torch.cat([est[:, i, :, :bw] for i, bw in enumerate(band_width)], dim=2)

        out = istft(est_spec.reshape(B * spk, self.enc_dim, T), self.win, self.stride, window,
                    length=nsample)
        return restore_output(out.reshape(B, spk, -1).to(in_dtype), was_one_d)
