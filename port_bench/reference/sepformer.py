"""Sepformer, the dual-path transformer (Subakan et al., "Attention is All
You Need in Speech Separation", arXiv:2010.13154), as look2hear's
``models/sepformer.py`` (SpeechBrain's ``Dual_Path_Model``) runs it with
gLN and no causal mask, in plain float32 PyTorch from a ``state_dict``.

Encoder (N filters of length k, stride k/2, no bias, no input padding)
and ReLU; gLN (eps 1e-8) and a bias-free 1x1; 50%-overlap chunks of K
frames; ``masknet_numlayers`` dual blocks, each an intra stack over the K
frames of every chunk and then an inter stack over the S chunks at every
position, each stack followed by gLN over the whole sample and a
residual.  A stack: fixed sinusoidal positions added to its input, pre-
or post-norm transformer layers (LayerNorm eps 1e-6; multi-head
self-attention in ``nn.MultiheadAttention``'s layout, the logits scaled
by 1/sqrt(dh), softmax over the keys; a ReLU feed-forward), a final
LayerNorm.  Then PReLU, a 1x1 to N x speakers with bias, overlap-add of
the chunks, tanh(1x1) x sigmoid(1x1), a bias-free 1x1 and ReLU as the
mask, the mask on the encoding, the transposed-conv decoder, padded or
cropped to the input's length.  Dropout acts only in training: this
forward is the eval one.

Departures from look2hear, each where the port departs too:

- look2hear multiplies the mask, held [speakers, B, N, L], with the
  encoding and reshapes it to [speakers * B, N, L] before the decoder,
  and then to [B, speakers, T]: for B > 1 that reassigns (batch, speaker)
  slots (``tests/test_batch_consistency.py`` documents it).  Here every
  item keeps its own estimates: [B, speakers, N, L] -> [B * speakers, N, L].
- The sinusoidal table is built in float64 and rounded once to float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import Quant, conv1d, conv_transpose1d, gln, init_range, matmul, prelu, qq
from .tasnet_dprnn import chunk, merge  # look2hear's 50%-overlap chunking, shared by its dual-path models

GLN_EPS = 1e-8
LN_EPS = 1e-6
SIDES = ("intra", "inter")


def param_shapes(cfg) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every parameter, in the model's
    order, its seeded draw uniform in offset +- scale: convs and linears
    +-1/sqrt(fan-in), a bias by its weight's, the attention's input
    projection Xavier (``nn.MultiheadAttention``'s init), norm weights
    1 +- 0.1 and biases +- 0.1, the PReLU slope 0.25 +- 0.05."""
    leaves = _leaves(cfg)
    shapes = {n: s for n, s, _ in leaves}
    out = []
    for name, shape, kind in leaves:
        if kind == "xavier":
            out.append((name, shape, math.sqrt(6 / (shape[0] + shape[1])), 0.0))
        else:
            out.append((name, shape, *init_range(kind, shape, _fan_in(name, shapes) if kind == "conv" else 1)))
    return out


def _leaves(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter: look2hear's keys."""
    N, k, spk = cfg["encoder_out_nchannels"], cfg["encoder_kernel_size"], cfg["masknet_numspks"]
    out = [("encoder.conv1d.weight", (N, 1, k), "conv"),
           ("masknet.norm.weight", (N,), "norm_w"), ("masknet.norm.bias", (N,), "norm_b"),
           ("masknet.conv1d.weight", (N, N, 1), "conv")]
    for i in range(cfg["masknet_numlayers"]):
        for side in SIDES:
            dffn = cfg[f"{side}_dffn"]
            stack = f"masknet.dual_mdl.{i}.{side}_mdl.mdl."
            for j in range(cfg[f"{side}_numlayers"]):
                p = f"{stack}layers.{j}."
                out += [(p + "self_att.att.in_proj_weight", (3 * N, N), "xavier"),
                        (p + "self_att.att.in_proj_bias", (3 * N,), "conv"),
                        (p + "self_att.att.out_proj.weight", (N, N), "conv"),
                        (p + "self_att.att.out_proj.bias", (N,), "conv"),
                        (p + "pos_ffn.ffn.0.weight", (dffn, N), "conv"), (p + "pos_ffn.ffn.0.bias", (dffn,), "conv"),
                        (p + "pos_ffn.ffn.3.weight", (N, dffn), "conv"), (p + "pos_ffn.ffn.3.bias", (N,), "conv")]
                out += [(f"{p}{n}.{w}", (N,), kind) for n in ("norm1", "norm2")
                        for w, kind in (("weight", "norm_w"), ("bias", "norm_b"))]
            out += [(stack + "norm.weight", (N,), "norm_w"), (stack + "norm.bias", (N,), "norm_b")]
        for side in SIDES:
            p = f"masknet.dual_mdl.{i}.{side}_norm."
            out += [(p + "weight", (N,), "norm_w"), (p + "bias", (N,), "norm_b")]
    out += [("masknet.prelu.weight", (1,), "prelu"),
            ("masknet.conv2d.weight", (N * spk, N, 1, 1), "conv"), ("masknet.conv2d.bias", (N * spk,), "conv"),
            ("masknet.output.0.weight", (N, N, 1), "conv"), ("masknet.output.0.bias", (N,), "conv"),
            ("masknet.output_gate.0.weight", (N, N, 1), "conv"), ("masknet.output_gate.0.bias", (N,), "conv"),
            ("masknet.end_conv1x1.weight", (N, N, 1), "conv"),
            ("decoder.weight", (N, 1, k), "conv")]
    return out


def _fan_in(name: str, shapes: Dict[str, tuple]) -> int:
    """A conv or linear weight's dim 1 x taps (the decoder, a transposed
    conv, too, as torch's default init); a bias takes its weight's."""
    w = shapes[name[: -len("bias")] + "weight"] if name.endswith("bias") else shapes[name]
    return w[1] * int(np.prod(w[2:]))


def positions(T: int, d: int, device) -> torch.Tensor:
    """The sinusoidal table [T, d]: sin at the even columns, cos at the odd,
    frequencies 10000^(-2i/d)."""
    pos = np.arange(T)[:, None].astype(np.float64)
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    table = np.zeros((T, d))
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: d // 2])
    return torch.from_numpy(table).to(device=device, dtype=torch.float32)


def layer_norm(x, sd, p: str):
    return F.layer_norm(x, x.shape[-1:], sd[p + "weight"], sd[p + "bias"], LN_EPS)


def attention(x: torch.Tensor, sd, p: str, nhead: int, q: Quant = None) -> torch.Tensor:
    """Multi-head self-attention on x [n, T, d]: the input projection, per
    head softmax(q k^T / sqrt(dh)) v, the output projection."""
    n, T, d = x.shape
    dh = d // nhead
    qkv = matmul(x, sd[p + "in_proj_weight"].t(), q) + sd[p + "in_proj_bias"]  # [n, T, 3d]
    qh, kh, vh = (t.reshape(n, T, nhead, dh).transpose(1, 2).reshape(n * nhead, T, dh) for t in qkv.split(d, -1))
    attn = torch.softmax(matmul(qh, kh.transpose(1, 2), q) / math.sqrt(dh), dim=-1)  # [n h, T, T]
    o = matmul(attn, vh, q).reshape(n, nhead, T, dh).transpose(1, 2).reshape(n, T, d)
    return matmul(o, sd[p + "out_proj.weight"].t(), q) + sd[p + "out_proj.bias"]


def feed_forward(x, sd, p: str, q: Quant = None):
    h = torch.relu(matmul(x, sd[p + "ffn.0.weight"].t(), q) + sd[p + "ffn.0.bias"])
    return matmul(h, sd[p + "ffn.3.weight"].t(), q) + sd[p + "ffn.3.bias"]


def stack(x: torch.Tensor, sd, p: str, cfg, side: str, q: Quant = None) -> torch.Tensor:
    """One transformer stack on x [n, T, d]: positions, the layers, the
    final LayerNorm."""
    nhead, pre = cfg[f"{side}_nhead"], cfg[f"{side}_norm_before"]
    if cfg[f"{side}_use_positional"]:
        x = x + positions(x.shape[1], x.shape[2], x.device)
    for j in range(cfg[f"{side}_numlayers"]):
        lp = f"{p}layers.{j}."
        if pre:
            x = x + attention(layer_norm(x, sd, lp + "norm1."), sd, lp + "self_att.att.", nhead, q)
            x = x + feed_forward(layer_norm(x, sd, lp + "norm2."), sd, lp + "pos_ffn.", q)
        else:
            x = layer_norm(x + attention(x, sd, lp + "self_att.att.", nhead, q), sd, lp + "norm1.")
            x = layer_norm(x + feed_forward(x, sd, lp + "pos_ffn.", q), sd, lp + "norm2.")
    return layer_norm(x, sd, p + "norm.")


def pointwise(x, sd, p: str, q: Quant = None):
    """A 1x1 conv on [b, C, L] from ``p``'s weight and, if it has one, bias."""
    return conv1d(x, sd[p + "weight"], sd.get(p + "bias"), q=q)


def forward(sd: Dict[str, torch.Tensor], wav: torch.Tensor, cfg, q: Quant = None) -> torch.Tensor:
    """[batch, T] -> [batch, speakers, T] in float32."""
    N, k, spk, K = (cfg["encoder_out_nchannels"], cfg["encoder_kernel_size"], cfg["masknet_numspks"],
                    cfg["masknet_chunksize"])
    x = wav.float()
    nb, T = x.shape
    enc = torch.relu(conv1d(x[:, None], sd["encoder.conv1d.weight"], q=q, stride=k // 2))  # [batch, N, L]
    h = gln(enc, sd["masknet.norm.weight"], sd["masknet.norm.bias"], GLN_EPS)
    h = pointwise(h, sd, "masknet.conv1d.", q)
    cur, rest = chunk(h, K)  # [batch, N, K, S]
    _, _, _, S = cur.shape
    for i in range(cfg["masknet_numlayers"]):
        p = f"masknet.dual_mdl.{i}."
        intra = stack(cur.permute(0, 3, 2, 1).reshape(nb * S, K, N), sd, p + "intra_mdl.mdl.", cfg, "intra", q)
        intra = intra.reshape(nb, S, K, N).permute(0, 3, 2, 1)
        intra = gln(intra, sd[p + "intra_norm.weight"], sd[p + "intra_norm.bias"], GLN_EPS) + cur
        inter = stack(intra.permute(0, 2, 3, 1).reshape(nb * K, S, N), sd, p + "inter_mdl.mdl.", cfg, "inter", q)
        inter = inter.reshape(nb, K, S, N).permute(0, 3, 1, 2)
        cur = gln(inter, sd[p + "inter_norm.weight"], sd[p + "inter_norm.bias"], GLN_EPS) + intra
    cur = prelu(cur, sd["masknet.prelu.weight"])
    w2, cur = qq(q, sd["masknet.conv2d.weight"][:, :, 0, 0], cur)
    h = torch.einsum("dc,bcks->bdks", w2, cur) + sd["masknet.conv2d.bias"][None, :, None, None]
    h = merge(h.reshape(nb * spk, N, K, S), rest)  # [batch * speakers, N, L]
    gated = torch.tanh(pointwise(h, sd, "masknet.output.0.", q)) * torch.sigmoid(
        pointwise(h, sd, "masknet.output_gate.0.", q))
    mask = torch.relu(pointwise(gated, sd, "masknet.end_conv1x1.", q)).reshape(nb, spk, N, -1)
    masked = (enc[:, None] * mask).reshape(nb * spk, N, -1)
    est = conv_transpose1d(masked, sd["decoder.weight"], q=q, stride=k // 2)[:, 0].reshape(nb, spk, -1)
    return F.pad(est, (0, T - est.shape[-1])) if T > est.shape[-1] else est[:, :, :T]


def frames(cfg, T: int) -> int:
    """Encoder frames of a T-sample wave (no input padding)."""
    k = cfg["encoder_kernel_size"]
    return (T - k) // (k // 2) + 1


def chunks(cfg, frames_: int) -> int:
    """S: the chunks of K frames the encoding is cut into."""
    K = cfg["masknet_chunksize"]
    stride = K // 2
    rest = K - (stride + frames_ % K) % K
    return 2 * (frames_ + rest + stride) // K


def attention_shapes(cfg, batch: int, T: int) -> List[Tuple[int, int, int]]:
    """(BH, dh, T) of every attention of one forward of ``batch`` waves of
    T samples, in order: per dual block the intra stack's layers over the
    K frames of each of the batch x S chunks, then the inter stack's over
    the S chunks at each of the batch x K positions."""
    N, K = cfg["encoder_out_nchannels"], cfg["masknet_chunksize"]
    S = chunks(cfg, frames(cfg, T))
    out = []
    for _ in range(cfg["masknet_numlayers"]):
        for side, n, length in (("intra", batch * S, K), ("inter", batch * K, S)):
            h = cfg[f"{side}_nhead"]
            out += [(n * h, N // h, length)] * cfg[f"{side}_numlayers"]
    return out


def forward_flops(cfg, T: int) -> int:
    """Products' FLOPs of one forward of a T-sample wave (2 a multiply-add):
    encoder, the 1x1 in, per transformer layer the input projection, the
    logits, the weighted sum, the output projection and the feed-forward,
    the 1x1 to the speakers, the gate's three 1x1s a speaker and the
    decoder; norms, softmax, positions and elementwise operations not
    counted."""
    N, k, spk, K = (cfg["encoder_out_nchannels"], cfg["encoder_kernel_size"], cfg["masknet_numspks"],
                    cfg["masknet_chunksize"])
    L = frames(cfg, T)
    S = chunks(cfg, L)
    per_block = 0
    for side, seqs, length in (("intra", S, K), ("inter", K, S)):
        layer = seqs * length * (2 * 4 * N * N + 2 * 2 * N * cfg[f"{side}_dffn"]) + seqs * 2 * 2 * length * length * N
        per_block += cfg[f"{side}_numlayers"] * layer
    return (L * (2 * k * N + 2 * N * N) + cfg["masknet_numlayers"] * per_block + K * S * 2 * N * N * spk
            + spk * L * (3 * 2 * N * N + 2 * N * k))
