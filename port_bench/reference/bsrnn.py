"""BSRNN, the band-split RNN (Luo and Yu, "Music Source Separation with
Band-split RNN", arXiv:2209.15174), as look2hear's ``models/bsrnn.py`` runs
it for wsj0-2mix, in plain float32 PyTorch from a ``state_dict``.

A Hann STFT (``torch.stft``: a periodic window of ``win`` samples, hop
``stride``, centred frames with reflect padding, one-sided: win/2 + 1
bins); the bins cut into bands of uneven width (``band_widths``: 100 Hz
bands at the bottom, then 250, 500, 1k and 2k Hz ones as the sample rate
allows, the rest in one last band); per band a gLN (eps float32's machine
epsilon) over its real and imaginary rows and a 1x1 to ``feature_dim`` N;
``num_repeat`` BSNets, each ``num_layer`` residual RNNs over the frames of
every band and then one across the bands at every frame (a residual RNN:
gLN, a bidirectional LSTM of hidden 2N, a linear back to N, the input
added); per band a mask head (gLN, 1x1 to 4N, tanh, 1x1 4N to 4N, tanh,
1x1 to 4 x the band's width, PReLU, 1x1 to that x the speakers, viewed as
[2, 2 (real, imaginary), speakers, width, frames] and gated over its first
axis: the first half times the sigmoid of the second); the complex mask
times the band's spectrum; the bands concatenated; ``torch.istft`` with
the same window, cropped to the input's length.  LSTM gates i, f, g, o,
zero initial state, the two biases summed, the backward direction reading
the sequence reversed (``tasnet_dprnn.bilstm``).  Dropout acts only in
training: this forward is the eval one (the configuration's dropout is 0).

Each band is a loop iteration of its own, as in look2hear: its own gLN and
1x1, its own mask head, the bands concatenated back.  (The port pads the
bands to the widest and batches them, so a fault in its padding or its
band masks shows here.)

Departures from look2hear:

- The sample rate, which sets the bands, is not among a configuration's
  ``model_args`` (the harness hands the configuration's own to the
  model): ``param_shapes``, ``forward_flops`` and ``lstm_shapes`` take it
  from ``cfg["sample_rate"]`` where given, else wsj0-2mix's 8000 Hz;
  ``forward`` reads each band's width from its bottleneck's norm
  (``BN.{i}.0.weight``: twice the width).
- Only what the configuration runs: ``context`` 0 (no neighbouring frames
  in the mask) and ``bi_comm`` true (a bidirectional band-comm RNN); other
  values raise.
- look2hear's per-band power (``subband_power``) is computed there and
  never used; it is left out.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from .common import Quant, conv1d, gln, init_range, matmul, prelu
from .tasnet_dprnn import bilstm, fan_in

GLN_EPS = float(np.finfo(np.float32).eps)
SAMPLE_RATE = 8000  # wsj0-2mix; the configuration's datamodule sample_rate

# (band width in Hz, bands of it at 44.1 kHz, the sample rate it needs to exceed)
_BANDS = ((100, 10, 0), (250, 12, 0), (500, 8, 0), (1000, 8, 8000), (2000, 2, 16000))


def band_widths(sample_rate: int, n_bins: int) -> List[int]:
    """look2hear's partition of ``n_bins`` one-sided bins: per kind the
    bands of its width (floor of Hz over Nyquist x bins), their number
    scaled from 44.1 kHz (ceil), a kind taken only while it leaves bins for
    the last band (the 100 Hz bands always), the rest in one last band."""
    half = sample_rate / 2.0
    out: List[int] = []
    for hz, at_44k, above in _BANDS:
        if sample_rate <= above:
            continue
        w = int(math.floor(hz / half * n_bins))
        m = int(math.ceil(at_44k / 44100 * sample_rate))
        if hz == 100 or sum(out) + w * m < n_bins:
            out += [w] * m
    out.append(n_bins - sum(out))
    if min(out) <= 0:
        raise ValueError(f"a band of width 0 or less: {out}")
    return out


def _bands(cfg) -> List[int]:
    return band_widths(cfg.get("sample_rate", SAMPLE_RATE), cfg["win"] // 2 + 1)


def _check(cfg) -> None:
    if cfg["context"] != 0 or not cfg["bi_comm"]:
        raise ValueError("the reference runs context 0 with a bidirectional band-comm RNN only")


def param_shapes(cfg) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, scale, offset) of every parameter, in the model's
    order, its seeded draw uniform in offset +- scale (``common.init_range``:
    convs and linears +-1/sqrt(fan-in), a bias by its weight's, LSTMs
    +-1/sqrt(H), norm weights 1 +- 0.1 and biases +- 0.1, PReLU slopes
    0.25 +- 0.05)."""
    leaves = _leaves(cfg)
    shapes = {n: s for n, s, _ in leaves}
    return [(n, s, *init_range(k, s, fan_in(n, shapes) if k == "conv" else 1)) for n, s, k in leaves]


def _res_rnn_leaves(p: str, N: int, H: int) -> List[Tuple[str, tuple, str]]:
    out = [(p + "norm.weight", (N,), "norm_w"), (p + "norm.bias", (N,), "norm_b")]
    for s in ("", "_reverse"):
        out += [(f"{p}rnn.weight_ih_l0{s}", (4 * H, N), "lstm"), (f"{p}rnn.weight_hh_l0{s}", (4 * H, H), "lstm"),
                (f"{p}rnn.bias_ih_l0{s}", (4 * H,), "lstm"), (f"{p}rnn.bias_hh_l0{s}", (4 * H,), "lstm")]
    return out + [(p + "proj.weight", (N, 2 * H), "conv"), (p + "proj.bias", (N,), "conv")]


def _leaves(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter: look2hear's keys."""
    _check(cfg)
    N, spk = cfg["feature_dim"], cfg["num_spks"]
    bws = _bands(cfg)
    out = []
    for i, bw in enumerate(bws):
        out += [(f"BN.{i}.0.weight", (2 * bw,), "norm_w"), (f"BN.{i}.0.bias", (2 * bw,), "norm_b"),
                (f"BN.{i}.1.weight", (N, 2 * bw, 1), "conv"), (f"BN.{i}.1.bias", (N,), "conv")]
    for r in range(cfg["num_repeat"]):
        for j in range(cfg["num_layer"]):
            out += _res_rnn_leaves(f"separator.{r}.band_rnn.{j}.", N, 2 * N)
        out += _res_rnn_leaves(f"separator.{r}.band_comm.", N, 2 * N)
    for i, bw in enumerate(bws):
        p = f"mask.{i}."
        out += [(p + "0.weight", (N,), "norm_w"), (p + "0.bias", (N,), "norm_b"),
                (p + "1.weight", (4 * N, N, 1), "conv"), (p + "1.bias", (4 * N,), "conv"),
                (p + "3.weight", (4 * N, 4 * N, 1), "conv"), (p + "3.bias", (4 * N,), "conv"),
                (p + "5.weight", (4 * bw, 4 * N, 1), "conv"), (p + "5.bias", (4 * bw,), "conv"),
                (p + "6.weight", (1,), "prelu"),
                (p + "7.weight", (4 * spk * bw, 4 * bw, 1), "conv"), (p + "7.bias", (4 * spk * bw,), "conv")]
    return out


def res_rnn(x: torch.Tensor, sd, p: str, q: Quant = None) -> torch.Tensor:
    """One residual RNN on x [n, N, T]: gLN, the bidirectional LSTM over T,
    the linear back to N, plus x."""
    h = gln(x, sd[p + "norm.weight"], sd[p + "norm.bias"], GLN_EPS)
    hs = bilstm(h.transpose(1, 2), sd, p + "rnn.", q)  # [n, T, 2H]
    out = matmul(hs, sd[p + "proj.weight"].t(), q) + sd[p + "proj.bias"]
    return x + out.transpose(1, 2)


def mask_head(x: torch.Tensor, sd, p: str, q: Quant = None) -> torch.Tensor:
    """One band's mask MLP on x [n, N, T] -> [n, 4 x speakers x width, T]."""
    h = gln(x, sd[p + "0.weight"], sd[p + "0.bias"], GLN_EPS)
    h = torch.tanh(conv1d(h, sd[p + "1.weight"], sd[p + "1.bias"], q=q))
    h = torch.tanh(conv1d(h, sd[p + "3.weight"], sd[p + "3.bias"], q=q))
    h = prelu(conv1d(h, sd[p + "5.weight"], sd[p + "5.bias"], q=q), sd[p + "6.weight"])
    return conv1d(h, sd[p + "7.weight"], sd[p + "7.bias"], q=q)


def forward(sd: Dict[str, torch.Tensor], wav: torch.Tensor, cfg, q: Quant = None) -> torch.Tensor:
    """[batch, T] -> [batch, speakers, T] in float32."""
    _check(cfg)
    win, stride, N, spk = cfg["win"], cfg["stride"], cfg["feature_dim"], cfg["num_spks"]
    x = wav.float()
    nb, T = x.shape
    nband = sum(1 for k in sd if k.startswith("BN.") and k.endswith(".0.weight"))
    bws = [sd[f"BN.{i}.0.weight"].shape[0] // 2 for i in range(nband)]
    if sum(bws) != win // 2 + 1:
        raise ValueError(f"bands {bws} do not cover the {win // 2 + 1} bins")
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=x.device)
    spec = torch.stft(x, win, stride, window=window, center=True, pad_mode="reflect",
                      return_complex=True)  # [nb, F, L]
    L = spec.shape[-1]
    starts = np.cumsum([0] + bws[:-1]).tolist()

    feats = []
    for i, (a, bw) in enumerate(zip(starts, bws)):
        band = spec[:, a:a + bw]
        ri = torch.cat([band.real, band.imag], dim=1)  # [nb, 2 bw, L]
        h = gln(ri, sd[f"BN.{i}.0.weight"], sd[f"BN.{i}.0.bias"], GLN_EPS)
        feats.append(conv1d(h, sd[f"BN.{i}.1.weight"], sd[f"BN.{i}.1.bias"], q=q))
    h = torch.stack(feats, dim=1)  # [nb, nband, N, L]

    for r in range(cfg["num_repeat"]):
        for j in range(cfg["num_layer"]):  # over the frames of every band
            h = res_rnn(h.reshape(nb * nband, N, L), sd, f"separator.{r}.band_rnn.{j}.", q).reshape(nb, nband, N, L)
        across = h.permute(0, 3, 2, 1).reshape(nb * L, N, nband)  # across the bands at every frame
        across = res_rnn(across, sd, f"separator.{r}.band_comm.", q)
        h = across.reshape(nb, L, N, nband).permute(0, 3, 2, 1)

    est = []
    for i, (a, bw) in enumerate(zip(starts, bws)):
        m = mask_head(h[:, i], sd, f"mask.{i}.", q).reshape(nb, 2, 2, spk, bw, L)
        m = m[:, 0] * torch.sigmoid(m[:, 1])  # [nb, 2 (real, imaginary), spk, bw, L]
        band = spec[:, None, a:a + bw]  # [nb, 1, bw, L]
        est.append(torch.complex(band.real * m[:, 0] - band.imag * m[:, 1],
                                 band.real * m[:, 1] + band.imag * m[:, 0]))
    est = torch.cat(est, dim=2)  # [nb, spk, F, L]
    out = torch.istft(est.reshape(nb * spk, win // 2 + 1, L), win, stride, window=window, center=True,
                      length=T)
    return out.reshape(nb, spk, T)


def frames(cfg, T: int) -> int:
    """STFT frames of a T-sample wave (centred)."""
    return T // cfg["stride"] + 1


def forward_flops(cfg, T: int) -> int:
    """Products' FLOPs of one forward of a T-sample wave (2 a multiply-add):
    the bands' 1x1s, per BSNet the residual RNNs' input and recurrent
    products of both directions and their projections (each over nband x
    frames positions), and the mask heads' four 1x1s; the FFTs, norms,
    gates and elementwise operations not counted."""
    _check(cfg)
    N, spk = cfg["feature_dim"], cfg["num_spks"]
    H = 2 * N
    bws = _bands(cfg)
    L = frames(cfg, T)
    res_rnn_ = len(bws) * L * (2 * 2 * N * 4 * H + 2 * 2 * H * 4 * H + 2 * 2 * H * N)
    mask = sum(2 * N * 4 * N + 2 * 16 * N * N + 2 * 4 * N * 4 * bw + 2 * 4 * bw * 4 * spk * bw for bw in bws)
    return L * (2 * N * 2 * sum(bws) + mask) + cfg["num_repeat"] * (cfg["num_layer"] + 1) * res_rnn_


def _kernel(T: int, B: int, Din: int, H: int):
    """The port's LSTM kernel for B sequences of T steps, Din into H
    (``ops/rnn.py::kernel_choice`` inside ``lstm_kernel_ok``, frozen here as
    the shapes the readers count): "K5" where Din % 16 != 0, where Din >=
    128, T >= 64 and B <= 16, and where Din < 128, T >= 128 and B <= 128;
    "K6" elsewhere; None outside the kernels' hidden widths."""
    if H % 16 or not 16 <= H <= 256:
        return None
    if Din % 16 or (Din >= 128 and T >= 64 and B <= 16) or (Din < 128 and T >= 128 and B <= 128):
        return "K5"
    return "K6"


def lstm_shapes(cfg, batch: int, T: int) -> Dict[str, list]:
    """The kernel launches of one served forward of ``batch`` waves of T
    samples, in order: {"K5": [(T, D, B, H)], "K6": [(T, B, Din, H, D)]};
    per BSNet the band RNNs (batch x nband sequences of the frames) and the
    band-comm RNN (batch x frames sequences of the nband bands), every one
    bidirectional."""
    _check(cfg)
    N = cfg["feature_dim"]
    H, nband, L = 2 * N, len(_bands(cfg)), frames(cfg, T)
    out = {"K5": [], "K6": []}
    calls = ([(L, batch * nband)] * cfg["num_layer"] + [(nband, batch * L)]) * cfg["num_repeat"]
    for steps, seqs in calls:
        k = _kernel(steps, seqs, N, H)
        if k == "K5":
            out["K5"].append((steps, 2, seqs, H))
        elif k == "K6":
            out["K6"].append((steps, seqs, N, H, 2))
    return out
