"""Sandglasset (Lam, Wang, Su and Yu, "Sandglasset: A Light Multi-Granularity
Self-attentive Network for Time-Domain Speech Separation", arXiv:2103.00819),
as look2hear's ``models/sandglasset.py:262-434`` runs it, in plain float32
PyTorch from a ``state_dict``, channels first ([B, D, K, S]) as look2hear
holds its block tensor.

The mix, less its mean, over its peak magnitude (+1e-12) and scaled by
-5 dB; padded by win/2 on both sides and to a whole window; the encoder
(N filters of length win, stride win/2, no bias) and ReLU; gLN (eps 1e-8)
and a bias-free 1x1 to D; chunks of K frames, hop K/2, with a whole chunk
of zeros on both sides (``F.unfold``); ReLU and gLN (eps 1e-8).  Then
``n_repeats`` blocks, block i pooling by 4^i for i < n/2 and by
4^(n - i - 1) after (1, 4, 16, 16, 4, 1 at 6 blocks):

- local: a bidirectional LSTM over the K frames of every chunk, a linear
  2H -> D, gLN (eps 1e-5) over the whole sample, the block's input added;
- global: the K axis averaged in windows of 4^i (``F.avg_pool1d``, the
  tail that fills no window dropped) to Q rows; for the second half of the
  blocks the mirrored block's global output added (block n-1-i's); a
  LayerNorm (eps 1e-5), the sinusoidal positions over the S chunks, a
  multi-head self-attention over S at every one of the Q rows (``nn.
  MultiheadAttention``'s layout, logits over sqrt(dh), softmax over the
  keys), then LayerNorm(out + out) (eps 1e-5): look2hear adds the
  attention's dropped-out output to its output, not to its input, a quirk
  kept; that is the skip handed on; linear interpolation with aligned
  corners from Q back to K (``F.interpolate``), gLN (eps 1e-5), the local
  path's output added.

Then PReLU (one slope), a 1x1 conv D -> speakers x N with bias, softplus;
the overlap-add of the chunks (``F.fold``) divided by 2 and cropped to the
frames; per speaker ReLU and gLN (eps 1e-8) over its [N, frames]; the mask
times the encoding; a bias-free linear N -> win and the overlap-add of the
frames (``F.fold``), cropped back to the input.  LSTM gates i, f, g, o,
zero initial state, the two biases summed, the backward direction reading
the chunk reversed (``tasnet_dprnn.bilstm``).  Dropout acts only in
training: this forward is the eval one (the configuration's dropout is 0).

Departures from look2hear:

- ``hop_size`` is not read: look2hear's ``unfold`` steps by K/2 whatever
  it is (the defaults give 125 = 250/2); a configuration with another
  raises.  ``norm_type``, ``mask_act``, ``bidirectional``, ``rnn_type``
  and ``num_layers`` are look2hear's constructor arguments that its
  forward does not read either (gLN, softplus and one bidirectional LSTM
  whatever they say); they are not read here.
- The sinusoidal table is built in float64 and rounded once to float32.
- Every item of a batch keeps its own statistics and estimates (the
  reference normalises each mix by its own peak, as look2hear does per
  row).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .bsrnn import _kernel
from .common import Quant, conv1d, gln, init_range, matmul, prelu, qq
from .sepformer import attention, positions
from .tasnet_dprnn import bilstm

GLN_EPS_OUTER = 1e-8  # enc_LN, seg_norm, out_norm
GLN_EPS_BLOCK = 1e-5  # intra_norm, inter_norm
LN_EPS = 1e-5


def _check(cfg) -> None:
    if cfg["hop_size"] != cfg["chunk_size"] // 2:
        raise ValueError("look2hear's chunks step by chunk_size / 2; hop_size must be that")


def pool_of(block: int, n_blocks: int) -> int:
    """The pooling window of block ``block``: 4^i in the first half, then
    mirrored."""
    return 4 ** block if block < n_blocks // 2 else 4 ** (n_blocks - block - 1)


def param_shapes(cfg) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every parameter, in the model's
    order, its seeded draw uniform in offset +- scale: convs and linears
    +-1/sqrt(fan-in), a bias by its weight's, the attention's input
    projection Xavier (``nn.MultiheadAttention``'s init), LSTMs
    +-1/sqrt(H), norm weights 1 +- 0.1 and biases +- 0.1, the PReLU slope
    0.25 +- 0.05."""
    out = []
    for name, shape, kind, fan in _leaves(cfg):
        if kind == "xavier":
            out.append((name, shape, math.sqrt(6 / (shape[0] + shape[1])), 0.0))
        else:
            out.append((name, shape, *init_range(kind, shape, fan)))
    return out


def _leaves(cfg) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan-in) of every parameter: look2hear's keys."""
    _check(cfg)
    N, D, H, win, spk = cfg["n_feats"], cfg["bn_chan"], cfg["hid_size"], cfg["kernel_size"], cfg["n_src"]
    out = [("encoder.weight", (N, 1, win), "conv", win),
           ("enc_LN.weight", (N,), "norm_w", 1), ("enc_LN.bias", (N,), "norm_b", 1),
           ("bottleneck.weight", (D, N, 1), "conv", N),
           ("seg_norm.weight", (D,), "norm_w", 1), ("seg_norm.bias", (D,), "norm_b", 1)]
    for i in range(cfg["n_repeats"]):
        p = f"sep_net.{i}."
        for s in ("", "_reverse"):
            out += [(f"{p}intra_RNN.rnn.weight_ih_l0{s}", (4 * H, D), "lstm", 1),
                    (f"{p}intra_RNN.rnn.weight_hh_l0{s}", (4 * H, H), "lstm", 1),
                    (f"{p}intra_RNN.rnn.bias_ih_l0{s}", (4 * H,), "lstm", 1),
                    (f"{p}intra_RNN.rnn.bias_hh_l0{s}", (4 * H,), "lstm", 1)]
        a = p + "inter_RNN."
        out += [(p + "intra_linear.weight", (D, 2 * H), "conv", 2 * H), (p + "intra_linear.bias", (D,), "conv", 2 * H),
                (p + "intra_norm.weight", (D,), "norm_w", 1), (p + "intra_norm.bias", (D,), "norm_b", 1),
                (a + "attn_in_norm.weight", (D,), "norm_w", 1), (a + "attn_in_norm.bias", (D,), "norm_b", 1),
                (a + "attn_layer.0.attn.in_proj_weight", (3 * D, D), "xavier", D),
                (a + "attn_layer.0.attn.in_proj_bias", (3 * D,), "conv", D),
                (a + "attn_layer.0.attn.out_proj.weight", (D, D), "conv", D),
                (a + "attn_layer.0.attn.out_proj.bias", (D,), "conv", D),
                (a + "attn_layer.0.norm.weight", (D,), "norm_w", 1), (a + "attn_layer.0.norm.bias", (D,), "norm_b", 1),
                (p + "inter_norm.weight", (D,), "norm_w", 1), (p + "inter_norm.bias", (D,), "norm_b", 1)]
    out += [("first_out.0.weight", (1,), "prelu", 1),
            ("first_out.1.weight", (spk * N, D, 1, 1), "conv", D), ("first_out.1.bias", (spk * N,), "conv", D),
            ("out_norm.weight", (N,), "norm_w", 1), ("out_norm.bias", (N,), "norm_b", 1),
            ("decoder.basis_lin.weight", (win, N), "conv", N)]
    return out


def layer_norm(x, sd, p: str):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"], LN_EPS)


def _pads(cfg, T: int) -> Tuple[int, int]:
    """(hop, rest): the encoder's hop and the zeros that make the padded
    wave a whole number of windows."""
    win = cfg["kernel_size"]
    hop = win // 2
    return hop, win - (hop + T % win) % win


def block(x: torch.Tensor, sd, i: int, cfg, skip=None, q: Quant = None):
    """Block ``i`` on x [B, D, K, S]; returns (output, the global path's
    attention output [B*Q, S, D], the skip a mirrored block takes)."""
    B, D, K, S = x.shape
    p = f"sep_net.{i}."
    # local: the BiLSTM over the K frames of each of the B*S chunks
    rows = x.permute(0, 3, 2, 1).reshape(B * S, K, D)
    hs = bilstm(rows, sd, p + "intra_RNN.rnn.", q)  # [B*S, K, 2H]
    local = matmul(hs, sd[p + "intra_linear.weight"].t(), q) + sd[p + "intra_linear.bias"]
    local = local.reshape(B, S, K, D).permute(0, 3, 2, 1)  # [B, D, K, S]
    x = x + gln(local, sd[p + "intra_norm.weight"], sd[p + "intra_norm.bias"], GLN_EPS_BLOCK)

    # global: K pooled to Q, attention over the S chunks at each of the B*Q rows
    k = pool_of(i, cfg["n_repeats"])
    cols = x.permute(0, 3, 1, 2).reshape(B * S, D, K)
    pooled = F.avg_pool1d(cols, k) if k > 1 else cols  # [B*S, D, Q]
    Q = pooled.shape[-1]
    g = pooled.reshape(B, S, D, Q).permute(0, 3, 1, 2).reshape(B * Q, S, D)
    if skip is not None:
        g = g + skip
    a = p + "inter_RNN."
    h = layer_norm(g, sd, a + "attn_in_norm.") + positions(S, D, g.device)
    out = attention(h, sd, a + "attn_layer.0.attn.", cfg["n_head"], q)
    h = layer_norm(out + out, sd, a + "attn_layer.0.norm.")  # look2hear's residual quirk
    up = h.reshape(B, Q, S, D).permute(0, 2, 3, 1).reshape(B * S, D, Q)
    if Q != K:
        up = F.interpolate(up, size=K, mode="linear", align_corners=True)
    up = up.reshape(B, S, D, K).permute(0, 2, 3, 1)  # [B, D, K, S]
    return x + gln(up, sd[p + "inter_norm.weight"], sd[p + "inter_norm.bias"], GLN_EPS_BLOCK), h


def forward(sd: Dict[str, torch.Tensor], wav: torch.Tensor, cfg, q: Quant = None) -> torch.Tensor:
    """[batch, T] -> [batch, speakers, T] in float32."""
    _check(cfg)
    N, D, K, win, spk = cfg["n_feats"], cfg["bn_chan"], cfg["chunk_size"], cfg["kernel_size"], cfg["n_src"]
    x = wav.float()
    B, T = x.shape
    x = x - x.mean(dim=-1, keepdim=True)
    x = x / (x.abs().amax(dim=-1, keepdim=True) + 1e-12) / 10 ** (5.0 / 20.0)
    hop, rest = _pads(cfg, T)
    x = F.pad(x, (hop, hop + rest))
    enc = torch.relu(conv1d(x[:, None], sd["encoder.weight"], q=q, stride=hop))  # [B, N, I]
    enc = gln(enc, sd["enc_LN.weight"], sd["enc_LN.bias"], GLN_EPS_OUTER)
    feat = conv1d(enc, sd["bottleneck.weight"], q=q)  # [B, D, I]
    I = feat.shape[-1]
    chunks = F.unfold(feat[..., None], (K, 1), padding=(K, 0), stride=(K // 2, 1))  # [B, D*K, S]
    cur = chunks.reshape(B, D, K, -1)
    cur = gln(torch.relu(cur), sd["seg_norm.weight"], sd["seg_norm.bias"], GLN_EPS_OUTER)

    skips = []
    for i in range(cfg["n_repeats"]):
        if i < cfg["n_repeats"] // 2:
            cur, h = block(cur, sd, i, cfg, None, q)
            skips.append(h)
        else:
            cur, _ = block(cur, sd, i, cfg, skips.pop(), q)

    S = cur.shape[-1]
    cur = prelu(cur, sd["first_out.0.weight"])
    w, cur = qq(q, sd["first_out.1.weight"][:, :, 0, 0], cur)
    m = F.softplus(torch.einsum("ed,bdks->beks", w, cur) + sd["first_out.1.bias"][None, :, None, None])
    folded = F.fold(m.reshape(B, spk * N * K, S), (I + 2 * K, 1), (K, 1), stride=(K // 2, 1))
    est = (folded[:, :, K:K + I, 0] / 2.0).reshape(B * spk, N, I)
    est = gln(torch.relu(est), sd["out_norm.weight"], sd["out_norm.bias"], GLN_EPS_OUTER)
    masked = est.reshape(B, spk, N, I) * enc[:, None]
    frames_ = matmul(masked.transpose(2, 3), sd["decoder.basis_lin.weight"].t(), q)  # [B, spk, I, win]
    L = (I - 1) * hop + win
    sig = F.fold(frames_.reshape(B * spk, I, win).transpose(1, 2), (L, 1), (win, 1), stride=(hop, 1))[:, 0, :, 0]
    return sig[:, hop: L - (rest + hop)].reshape(B, spk, T)


def frames(cfg, T: int) -> int:
    """Encoder frames of a T-sample wave."""
    hop, rest = _pads(cfg, T)
    return (T + rest + 2 * hop - cfg["kernel_size"]) // hop + 1


def chunks(cfg, frames_: int) -> int:
    """S: the chunks of K frames, hop K/2, with K zeros on both sides."""
    K = cfg["chunk_size"]
    return (frames_ + K) // (K // 2) + 1


def _rows(cfg, i: int) -> int:
    """Q: the rows block ``i`` attends at, K pooled by its window."""
    k, K = pool_of(i, cfg["n_repeats"]), cfg["chunk_size"]
    return (K - k) // k + 1


def attention_shapes(cfg, batch: int, T: int) -> List[Tuple[int, int, int]]:
    """(BH, dh, T) of every attention of one forward of ``batch`` waves of
    T samples, in order: per block one over the S chunks at each of the
    batch x Q rows."""
    D, h = cfg["bn_chan"], cfg["n_head"]
    S = chunks(cfg, frames(cfg, T))
    return [(batch * _rows(cfg, i) * h, D // h, S) for i in range(cfg["n_repeats"])]


def lstm_shapes(cfg, batch: int, T: int) -> Dict[str, list]:
    """The kernel launches of one served forward of ``batch`` waves of T
    samples, in order: {"K5": [(T, D, B, H)], "K6": [(T, B, Din, H, D)]};
    per block the local BiLSTM over the K frames of each of the batch x S
    chunks (``bsrnn._kernel``'s frozen ``kernel_choice``)."""
    D, H, K = cfg["bn_chan"], cfg["hid_size"], cfg["chunk_size"]
    seqs = batch * chunks(cfg, frames(cfg, T))
    out = {"K5": [], "K6": []}
    for _ in range(cfg["n_repeats"]):
        kind = _kernel(K, seqs, D, H)
        if kind == "K5":
            out["K5"].append((K, 2, seqs, H))
        elif kind == "K6":
            out["K6"].append((K, seqs, D, H, 2))
    return out


def forward_flops(cfg, T: int) -> int:
    """Products' FLOPs of one forward of a T-sample wave (2 a multiply-add):
    the encoder and bottleneck at every frame; per block the local path's
    input and recurrent products of both directions and its projection at
    every one of the S x K chunk positions, and the global path's input
    projection, logits, weighted sum and output projection over the S
    chunks at each of its Q rows; the mask head's 1x1 at every chunk
    position and the decoder a speaker at every frame.  Norms, pooling,
    interpolation, softmax, positions and elementwise operations not
    counted."""
    N, D, H, K, win, spk = (cfg["n_feats"], cfg["bn_chan"], cfg["hid_size"], cfg["chunk_size"], cfg["kernel_size"],
                            cfg["n_src"])
    I = frames(cfg, T)
    S = chunks(cfg, I)
    local = S * K * (2 * 2 * D * 4 * H + 2 * 2 * H * 4 * H + 2 * 2 * H * D)
    blocks = 0
    for i in range(cfg["n_repeats"]):
        blocks += local + _rows(cfg, i) * (S * 2 * D * 3 * D + 2 * 2 * S * S * D + S * 2 * D * D)
    return I * (2 * win * N + 2 * N * D) + blocks + S * K * 2 * D * spk * N + spk * I * 2 * N * win
