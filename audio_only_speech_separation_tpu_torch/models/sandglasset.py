"""Sandglasset (counterpart of
``audio_only_speech_separation_tpu/models/sandglasset.py``; reference
look2hear/models/sandglasset.py:262-434), channels-last throughout.

Each block runs a local BiLSTM over the chunk axis and a global
self-attention over the chunk index at a rate that shrinks then grows
(pooling by 4^i, then mirrored: the "sandglass"), with skips across
mirrored blocks.  The signal is peak-normalised to -5 dB inside the model.
Chunks of K frames with hop K/2 and a full chunk of padding on both sides;
the fold divides by 2.

- The intra BiLSTM (``intra_RNN.rnn``) has ``intra_linear`` fused into its
  output; over B*S sequences it takes K6 in bf16 on the card, K5 over 16
  or fewer (``ops/rnn.py::kernel_choice``).
- Blocks 0 and n-1 pool by 1: the attention runs on the 4-D [B, S, K, D]
  block tensor over S with K batched (``ops/attention.py``'s 4-D form,
  K4 at [B*K*h, dh, S]).  The other blocks average K by 4^i
  (``ops/resample.py::avg_pool1d`` along K: a mean over a view, f32-summed
  and rounded once, where the JAX package takes a product with the
  averaging matrix; the weights 1/4^i are powers of two, so only the order
  of the sum differs) to [B*Q, S, D], attend there (K4 at [B*Q*h, dh, S]),
  and interpolate Q back to K (linear, aligned corners) as one product
  with the matrix rounded to the activation's dtype, as in the JAX
  package, which also restores the [B, S, K, D] layout.
- ``GlobalAttnLayer`` keeps the reference's residual quirk: it adds
  dropout(out) to out, not to its input.
- The gLNs are channels last: ``enc_LN``, ``seg_norm``, ``out_norm`` and
  each block's ``intra_norm`` and ``inter_norm``, those two with the
  block's residual handed in (``residual=x``), take K9 in bf16 on the card
  where ``GlobalLayerNorm.fuses`` holds (15 a call at 6 blocks), the
  residual added in the same pass.

The ``state_dict`` uses look2hear's keys (the JAX package's
``utils/torch_import.py::convert_sandglasset``): ``encoder.weight`` [N, 1,
win], ``enc_LN``, ``bottleneck.weight`` [D, N, 1], ``seg_norm``,
``sep_net.{i}.{intra_RNN.rnn, intra_linear, intra_norm,
inter_RNN.attn_in_norm, inter_RNN.attn_layer.0.{attn, norm}, inter_norm}``,
``first_out.{0, 1}``, ``out_norm`` and ``decoder.basis_lin.weight`` [win,
N].

Spans (``utils/profiling.py::span``): ``sandglasset.encode`` (the
normalisation, the encoder, ``enc_LN``, the bottleneck, the chunking and
``seg_norm``), per block ``sandglasset.local`` (the intra BiLSTM with its
projection, ``intra_norm`` and the residual: K6's and K9's launches
inside) and ``sandglasset.global`` (the pooling, the skip,
``attn_in_norm``, the positions, the attention layer, the interpolation,
``inter_norm`` and the residual: K4's and K9's launches inside),
``sandglasset.decode`` (the mask head, the fold, ``out_norm``, the mask
product and the decoder).

``norm_type``, ``mask_act``, ``bidirectional``, ``rnn_type`` and
``num_layers`` are kept for configs and checkpoints; the model ignores
them, as the JAX one does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import PReLU
from ..ops.attention import MultiheadAttention, positions_table
from ..ops.conv import frame_axis1, frame_signal, overlap_add, overlap_add_axis1
from ..ops.dropout import Dropout
from ..ops.norms import GlobalLayerNorm
from ..ops.resample import avg_pool1d, interpolate_linear_align_corners
from ..ops.rnn import BiLSTM
from ..utils.profiling import span
from . import register_model
from .base import BaseModel, normalize_input, restore_output, seeded_init_


def unfold_chunks(x: torch.Tensor, K: int):
    """x: [B, D, I] -> (channels-last chunks [B, S, K, D], I): a chunk of
    padding on both sides, hop K/2 (torch unfold semantics,
    sandglasset.py:383-395).  The chunks are a strided view of the padded
    [B, I + 2K, D] signal."""
    I = x.shape[2]
    return frame_axis1(F.pad(x.transpose(1, 2), (0, 0, K, K)), K, K // 2), I


def fold_chunks(chunks: torch.Tensor, ori_len: int) -> torch.Tensor:
    """The inverse of ``unfold_chunks`` ([B, S, K, D] channels-last in) with
    the reference's /2 normalisation -> [B, D, ori_len], a transposed view
    of the channels-last sum."""
    K = chunks.shape[2]
    return (overlap_add_axis1(chunks, K // 2)[:, K:K + ori_len] / 2.0).transpose(1, 2)


class GlobalAttnLayer(nn.Module):
    """MHA, then LayerNorm(out + dropout(out)) (sandglasset.py:52-72), on
    [B, S, D] or [B, S, K, D] (attention over S)."""

    def __init__(self, channels: int, n_head: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.attn = MultiheadAttention(channels, n_head, dropout=dropout, device=device)
        self.drop = Dropout(dropout)
        self.norm = nn.LayerNorm(channels, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.attn(x)
        return self.norm(out + self.drop(out))


class _InterRNN(nn.Module):
    """look2hear's ``inter_RNN``: the input LayerNorm and the attention
    layer under ``attn_layer.0``."""

    def __init__(self, channels: int, n_head: int, dropout: float, device=None):
        super().__init__()
        self.attn_in_norm = nn.LayerNorm(channels, eps=1e-5, device=device)
        self.attn_layer = nn.Sequential(GlobalAttnLayer(channels, n_head, dropout, device=device))


class _IntraRNN(nn.Module):
    """look2hear's ``intra_RNN``: the BiLSTM under ``rnn``."""

    def __init__(self, channels: int, hid_size: int, device=None):
        super().__init__()
        self.rnn = BiLSTM(channels, hid_size, device=device)


class SandglassetBlock(nn.Module):
    """Intra BiLSTM + downsampled inter attention (sandglasset.py:135-206)
    on [B, S, K, D]; returns (output, skip)."""

    def __init__(self, in_chan: int, hid_size: int, n_head: int = 8, block_i: int = 2,
                 model_n_block: int = 6, chunk_size: int = 64, dropout: float = 0.0, device=None):
        super().__init__()
        self.chunk_size = chunk_size
        if block_i < model_n_block // 2:
            self.kernel = 4 ** block_i
        else:
            self.kernel = 4 ** (model_n_block - block_i - 1)
        self.intra_RNN = _IntraRNN(in_chan, hid_size, device=device)
        self.intra_linear = nn.Linear(2 * hid_size, in_chan, device=device)
        self.intra_norm = GlobalLayerNorm(in_chan, eps=1e-5, channels_last=True, device=device)
        self.inter_RNN = _InterRNN(in_chan, n_head, dropout, device=device)
        self.inter_norm = GlobalLayerNorm(in_chan, eps=1e-5, channels_last=True, device=device)

    def forward(self, x: torch.Tensor, skip_connect=None):
        B, S, K, D = x.shape
        with span("sandglasset.local"):
            rnn = self.intra_RNN.rnn
            local = rnn(x.reshape(B * S, K, D), self.intra_linear.weight.t(), self.intra_linear.bias)
            x = self.intra_norm(local.reshape(B, S, K, D), residual=x)
        with span("sandglasset.global"):
            inter, kernel = self.inter_RNN, self.kernel
            if kernel == 1:  # the 4-D attention over S, K batched
                g = x if skip_connect is None else x + skip_connect
                h = inter.attn_in_norm(g) + positions_table(S, D, g.dtype, g.device)[None, :, None, :]
                h = inter.attn_layer(h)
                return self.inter_norm(h, residual=x), h

            pooled = avg_pool1d(x, kernel, dim=2)  # [B, S, Q, D]
            Q = pooled.shape[2]
            g = pooled.transpose(1, 2).reshape(B * Q, S, D)
            if skip_connect is not None:
                g = g + skip_connect
            h = inter.attn_in_norm(g) + positions_table(S, D, g.dtype, g.device)[None]
            h = inter.attn_layer(h)
            # [K, Q] @ [B, S, Q, D] -> [B, S, K, D]: the layout back in the product
            up = interpolate_linear_align_corners(h.reshape(B, Q, S, D).transpose(1, 2), self.chunk_size, dim=2)
            return self.inter_norm(up, residual=x), h


class _Decoder(nn.Module):
    """look2hear's decoder: ``basis_lin`` (Linear N -> win, no bias)."""

    def __init__(self, n_feats: int, win: int, device=None):
        super().__init__()
        self.basis_lin = nn.Linear(n_feats, win, bias=False, device=device)


@register_model
class Sandglasset(BaseModel):
    """Sandglasset with the JAX model's arguments.  ``generator`` seeds the
    initial weights (none: seed 0); ``device`` places them."""

    def __init__(self, n_feats=64, n_src=2, out_chan=64, bn_chan=128, hid_size=128, chunk_size=250,
                 hop_size=125, n_repeats=6, n_head=8, norm_type="gLN", mask_act="sigmoid",
                 bidirectional=True, rnn_type="LSTM", num_layers=1, dropout=0.0, kernel_size=2,
                 sr=16000, sample_rate=16000, device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.n_feats, self.n_src, self.out_chan, self.bn_chan = n_feats, n_src, out_chan, bn_chan
        self.hid_size, self.chunk_size, self.hop_size = hid_size, chunk_size, hop_size
        self.n_repeats, self.n_head, self.norm_type, self.mask_act = n_repeats, n_head, norm_type, mask_act
        self.bidirectional, self.rnn_type, self.num_layers = bidirectional, rnn_type, num_layers
        self.dropout, self.kernel_size, self.sr, self.sample_rate = dropout, kernel_size, sr, sample_rate
        win = kernel_size
        self.encoder = nn.Conv1d(1, n_feats, win, stride=win // 2, bias=False, device=device)
        self.enc_LN = GlobalLayerNorm(n_feats, eps=1e-8, channels_last=True, device=device)
        self.bottleneck = nn.Conv1d(n_feats, bn_chan, 1, bias=False, device=device)
        self.seg_norm = GlobalLayerNorm(bn_chan, eps=1e-8, channels_last=True, device=device)
        self.sep_net = nn.ModuleList([
            SandglassetBlock(bn_chan, hid_size, n_head, block_i=i, model_n_block=n_repeats,
                             chunk_size=chunk_size, dropout=dropout, device=device)
            for i in range(n_repeats)])
        self.first_out = nn.Sequential(PReLU(device=device),
                                       nn.Conv2d(bn_chan, n_src * n_feats, 1, device=device))
        self.out_norm = GlobalLayerNorm(n_feats, eps=1e-8, channels_last=True, device=device)
        self.decoder = _Decoder(n_feats, win, device=device)
        seeded_init_(self, generator)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        wav, was_one_d = normalize_input(wav)
        B, T = wav.shape
        win = self.kernel_size
        hop = win // 2
        rest = win - (hop + T % win) % win
        with span("sandglasset.encode"):
            # -5 dB peak normalisation (sandglasset.py:363-368)
            sig = wav - wav.sum(dim=-1, keepdim=True) / T
            sig = sig / (sig.abs().amax(dim=-1, keepdim=True) + 1e-12)
            sig = sig / (10 ** (5.0 / 20.0))
            sig = F.pad(sig, (hop, hop + rest))

            frames = frame_signal(sig, win, hop)  # [B, I, win]
            mixture_w = torch.relu(torch.matmul(frames, self.encoder.weight[:, 0, :].to(sig.dtype).t()))
            mixture_w = self.enc_LN(mixture_w)  # [B, I, N]
            out = torch.matmul(mixture_w, self.bottleneck.weight[:, :, 0].to(mixture_w.dtype).t())  # [B, I, D]
            chunks, I = unfold_chunks(out.transpose(1, 2), self.chunk_size)
            x = self.seg_norm(torch.relu(chunks))  # [B, S, K, D]

        skips = []
        for i, block in enumerate(self.sep_net):
            if i < self.n_repeats // 2:
                x, skip = block(x)
                skips.append(skip)
            else:
                x, _ = block(x, skips.pop())

        with span("sandglasset.decode"):
            # mask head: PReLU -> 1x1 Conv2d -> softplus, then the channels-last fold
            conv = self.first_out[1]
            x = self.first_out[0](x)
            x = torch.matmul(x, conv.weight[:, :, 0, 0].to(x.dtype).t()) + conv.bias.to(x.dtype)
            x = F.softplus(x)  # [B, S, K, n_src * N]
            sig_cl = fold_chunks(x, I).transpose(1, 2)  # [B, I, n_src * N]
            est = sig_cl.reshape(B, I, self.n_src, self.n_feats).transpose(1, 2)
            est = self.out_norm(torch.relu(est.reshape(B * self.n_src, I, self.n_feats)))
            masked = est.reshape(B, self.n_src, I, self.n_feats) * mixture_w[:, None]  # [B, C, I, N]

            dw = self.decoder.basis_lin.weight.to(masked.dtype).t()  # [N, win]
            dec = overlap_add(torch.matmul(masked, dw).reshape(B * self.n_src, I, win), hop)
            dec = dec.reshape(B, self.n_src, -1)
        return restore_output(dec[:, :, hop: dec.shape[-1] - (rest + hop)], was_one_d)
