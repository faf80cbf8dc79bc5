"""TasNet with a dual-path RNN core (Luo, Chen and Yoshioka,
arXiv:1910.06379) as look2hear's ``TasNet(module="DPRNN")`` runs it with
one group and ``unfold`` off, in plain float32 PyTorch from a
``state_dict``.

Encoder (enc_dim filters of length win, stride win/2, no bias), gLN (eps
float32's machine epsilon) and a bias-free 1x1 to bn_dim, 50%-overlap
chunks of block_size frames, ``layer`` dual-path layers (per layer a
bidirectional LSTM of hidden_dim over the frames of each chunk and a
linear projection back to bn_dim, gLN over the whole sample, residual;
then the same across the chunks at each position), a 1x1 output conv,
overlap-add of the chunks, a 1x1 + relu mask per speaker on the
encoding, and the transposed-conv decoder.  LSTM gates i, f, g, o, zero
initial state, the two biases summed; the backward direction reads the
sequence reversed.  The chunk padding is look2hear's ``_padding``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Quant, conv1d, conv_transpose1d, gln, init_range, matmul, qq

GLN_EPS_ENC = float(np.finfo(np.float32).eps)
GLN_EPS_CORE = 1e-8


def param_shapes(cfg) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every parameter, its seeded draw
    uniform in offset +- scale (``common.init_range``)."""
    leaves = _leaves(cfg)
    shapes = {n: s for n, s, _ in leaves}
    return [(n, s, *init_range(k, s, fan_in(n, shapes) if k == "conv" else 1)) for n, s, k in leaves]


def _leaves(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter."""
    enc, bn, h, win, spk = cfg["enc_dim"], cfg["bn_dim"], cfg["hidden_dim"], cfg["win"], cfg["num_spk"]
    out = [("encoder.weight", (enc, 1, win), "conv"),
           ("bottleneck.0.weight", (enc,), "norm_w"), ("bottleneck.0.bias", (enc,), "norm_b"),
           ("bottleneck.1.weight", (bn, enc, 1), "conv")]
    core = "seq_model.seq_model."
    for kind in ("row", "col"):
        for i in range(cfg["layer"]):
            p = f"{core}{kind}_rnn.{i}."
            for s in ("", "_reverse"):
                out += [(f"{p}rnn.weight_ih_l0{s}", (4 * h, bn), "lstm"),
                        (f"{p}rnn.weight_hh_l0{s}", (4 * h, h), "lstm"),
                        (f"{p}rnn.bias_ih_l0{s}", (4 * h,), "lstm"),
                        (f"{p}rnn.bias_hh_l0{s}", (4 * h,), "lstm")]
            out += [(p + "proj.weight", (bn, 2 * h), "conv"), (p + "proj.bias", (bn,), "conv")]
    for kind in ("row", "col"):
        for i in range(cfg["layer"]):
            out += [(f"{core}{kind}_norm.{i}.weight", (bn,), "norm_w"),
                    (f"{core}{kind}_norm.{i}.bias", (bn,), "norm_b")]
    out += [(core + "output.weight", (bn, bn, 1, 1), "conv"), (core + "output.bias", (bn,), "conv"),
            ("mask.0.weight", (enc * spk, bn, 1), "conv"), ("mask.0.bias", (enc * spk,), "conv"),
            ("decoder.weight", (enc, 1, win), "conv")]
    return out


def fan_in(name: str, shapes: Dict[str, tuple]) -> int:
    """The fan-in that sets a conv or linear leaf's init bound (a bias takes
    its weight's; the decoder, a transposed conv, its weight's dim 1 x
    taps, as torch's default init)."""
    w = shapes[name.rsplit(".", 1)[0] + ".weight"]
    return w[1] * int(np.prod(w[2:]))


def bilstm(x: torch.Tensor, sd, prefix: str, q: Quant = None) -> torch.Tensor:
    """[n, T, Din] -> [n, T, 2H]: both directions stepped together."""
    n, T, _ = x.shape
    w_ih = torch.stack([sd[prefix + "weight_ih_l0"], sd[prefix + "weight_ih_l0_reverse"]])  # [2, 4H, Din]
    w_hh = torch.stack([sd[prefix + "weight_hh_l0"], sd[prefix + "weight_hh_l0_reverse"]])  # [2, 4H, H]
    b = torch.stack([sd[prefix + "bias_ih_l0"] + sd[prefix + "bias_hh_l0"],
                     sd[prefix + "bias_ih_l0_reverse"] + sd[prefix + "bias_hh_l0_reverse"]])
    H = w_hh.shape[-1]
    xs = torch.stack([x, x.flip(1)])  # [2, n, T, Din]
    xw = matmul(xs, w_ih.transpose(1, 2)[:, None], q) + b[:, None, None]  # [2, n, T, 4H]
    w_hh_t = w_hh.transpose(1, 2)  # [2, H, 4H]
    h = x.new_zeros(2, n, H)
    c = x.new_zeros(2, n, H)
    outs = []
    for t in range(T):
        gates = xw[:, :, t] + matmul(h, w_hh_t, q)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    hs = torch.stack(outs, dim=2)  # [2, n, T, H]
    return torch.cat([hs[0], hs[1].flip(1)], dim=-1)


def chunk(x: torch.Tensor, K: int):
    """[b, C, T] -> ([b, C, K, S] of 50%-overlap chunks, rest)."""
    T = x.shape[-1]
    stride = K // 2
    rest = K - (stride + T % K) % K
    x = F.pad(x, (stride, rest + stride))
    nb, C, Tp = x.shape
    first = x[:, :, : Tp - stride].reshape(nb, C, -1, K)
    second = x[:, :, stride:].reshape(nb, C, -1, K)
    return torch.stack([first, second], dim=3).reshape(nb, C, -1, K).transpose(2, 3), rest


def merge(x: torch.Tensor, rest: int) -> torch.Tensor:
    """The overlap-add inverse of ``chunk``: [b, C, K, S] -> [b, C, T]."""
    nb, C, K, _ = x.shape
    stride = K // 2
    x = x.transpose(2, 3).reshape(nb, C, -1, 2 * K)
    first = x[:, :, :, :K].reshape(nb, C, -1)[:, :, stride:]
    second = x[:, :, :, K:].reshape(nb, C, -1)[:, :, :-stride]
    out = first + second
    return out[:, :, :-rest] if rest > 0 else out


def forward(sd: Dict[str, torch.Tensor], wav: torch.Tensor, cfg, q: Quant = None) -> torch.Tensor:
    """[batch, T] -> [batch, speakers, T] in float32."""
    win, enc_dim, spk, K = cfg["win"], cfg["enc_dim"], cfg["num_spk"], cfg["block_size"]
    x = wav.float()
    nb, T = x.shape
    stride = win // 2
    rest = win - (stride + T % win) % win
    x = F.pad(x, (stride, rest + stride))
    enc = conv1d(x[:, None], sd["encoder.weight"], q=q, stride=stride)  # [batch, enc, T']
    feat = gln(enc, sd["bottleneck.0.weight"], sd["bottleneck.0.bias"], GLN_EPS_ENC)
    feat = conv1d(feat, sd["bottleneck.1.weight"], q=q)  # [batch, bn, T']
    blocks, blk_rest = chunk(feat, K)
    core = "seq_model.seq_model."
    cur = blocks.permute(0, 3, 2, 1)  # [batch, S, K, bn]: rows
    for i in range(cfg["layer"]):
        for kind in ("row", "col"):
            p = f"{core}{kind}_rnn.{i}."
            b, A, Bq, n = cur.shape
            hs = bilstm(cur.reshape(b * A, Bq, n), sd, p + "rnn.", q)
            out = matmul(hs, sd[p + "proj.weight"].t(), q) + sd[p + "proj.bias"]
            out = gln(out.reshape(cur.shape), sd[f"{core}{kind}_norm.{i}.weight"],
                      sd[f"{core}{kind}_norm.{i}.bias"], GLN_EPS_CORE, channel_axis=3)
            cur = (cur + out).transpose(1, 2)  # rows [b, S, K, n] <-> columns [b, K, S, n]
    cur = cur.permute(0, 3, 2, 1)  # rows [batch, S, K, bn] -> [batch, bn, K, S]
    w_out, b_out = qq(q, sd[core + "output.weight"][:, :, 0, 0])[0], sd[core + "output.bias"]
    core_out = torch.einsum("bcks,dc->bdks", qq(q, cur)[0], w_out) + b_out[None, :, None, None]
    fmap = merge(core_out, blk_rest)  # [batch, bn, T']
    m = torch.relu(conv1d(fmap, sd["mask.0.weight"], sd["mask.0.bias"], q=q))
    masked = m.reshape(nb, spk, enc_dim, -1) * enc[:, None]
    s = conv_transpose1d(masked.reshape(nb * spk, enc_dim, -1), sd["decoder.weight"], q=q, stride=stride)[:, 0]
    s = s[:, stride: s.shape[-1] - (rest + stride)]
    return s.reshape(nb, spk, -1)


def frames(cfg, T: int) -> int:
    win = cfg["win"]
    stride = win // 2
    rest = win - (stride + T % win) % win
    return (T + rest + 2 * stride - win) // stride + 1


def chunk_positions(cfg, frames_: int) -> int:
    """K x S: the frames the dual-path layers see after chunking."""
    K = cfg["block_size"]
    stride = K // 2
    rest = K - (stride + frames_ % K) % K
    padded = frames_ + rest + 2 * stride
    return 2 * (padded - stride)


def forward_flops(cfg, T: int) -> int:
    """Products' FLOPs of one forward of a T-sample wave (2 a multiply-add):
    encoder, bottleneck, per layer two passes of a bidirectional LSTM (the
    input and recurrent products of each step) and its projection, the
    output 1x1, mask head and decoder; norms, gates and elementwise
    operations not counted."""
    enc, bn, h, win, spk = cfg["enc_dim"], cfg["bn_dim"], cfg["hidden_dim"], cfg["win"], cfg["num_spk"]
    f = frames(cfg, T)
    pos = chunk_positions(cfg, f)
    lstm = 2 * (2 * bn * 4 * h + 2 * h * 4 * h) + 2 * 2 * h * bn  # both directions, then the projection
    return (f * (2 * win * enc + 2 * enc * bn + 2 * bn * spk * enc + 2 * spk * enc * win)
            + pos * (cfg["layer"] * 2 * lstm + 2 * bn * bn))
