"""Whole-separator ConvTasNet forward: CUDA kernel wrapper, its plain
version, and the host weight packers (counterpart of
``audio_only_speech_separation_tpu/ops/pallas/convtasnet_block.py``).

Per sample, the separator computes (``csrc/convtasnet_separator.cu``):

1. ``enc = frames @ we``, stored in bf16;
2. the bottleneck gLN + 1x1 as pseudo-block 0, in the delayed form
   ``y = rstd*(enc @ wsg0) + c0_0 - mean*rstd*c0_1``;
3. per block with dilation d: ``h = PReLU(y @ W1 + b1)`` (f32) and its gLN
   statistics; ``u = dwb + sum_k dw_k * norm1(h)[t + (k-1)d]`` with zeros
   outside [0, T'); ``v = PReLU(u)`` and its statistics;
   ``y += rstd2*(v @ wsg) + c0 - mean2*rstd2*c1``, with ``wsg = g2 * Ws``,
   ``c0 = b2 @ Ws + bs`` and ``c1 = g2 @ Ws`` folded by the packer;
4. the mask ``relu|sigmoid(y @ wm + bm)``, times ``enc``, then ``@ wd``:
   decoder frames [B, nspk, T', win] in bf16.

Dtype policy: bf16 matmul operands with f32 accumulation, f32 elementwise
chain and statistics (variance clamped at 0, eps 1e-8), y rounded to bf16
after each block.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

# vecs packing rows (f32 [nb, 8, H]); row 7 is unused padding
_B1, _DWB, _G1, _BT1, _DW0, _DW1, _DW2 = range(7)
_EPS = 1e-8
_C = 128  # bottleneck channels the kernel takes
_WIN = 16  # filter length the kernel takes


def _np(a, dtype=np.float64) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().float().numpy()
    return np.asarray(a, dtype)


def _to(a, dtype, device) -> torch.Tensor:
    """numpy -> a contiguous tensor, rounded once from f32 to ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, dtype)


def pack_convtasnet_tcn_params(state_dict, R: int, X: int, device=None):
    """Pack the R*X blocks of a port ConvTasNet ``state_dict`` into the
    stacked arrays the kernel takes.  The delayed-norm constants
    (g2*Ws, b2@Ws + bs, g2@Ws) are folded in f64, once.

    Returns (w1s [nb, C, H] bf16, wsgs [nb, H, C] bf16, vecs [nb, 8, H] f32,
    cs [nb, 2, C] f32, alphas [nb, 2] f32, dilations)."""
    sd = state_dict
    w1s, wsgs, vecs, cs, alphas, dils = [], [], [], [], [], []
    for r in range(R):
        for i in range(X):
            pre = f"separation.sep.{r}.tcn.{i}"
            w1s.append(_np(sd[f"{pre}.conv1x1.weight"], np.float32)[:, :, 0].T)  # [C, H]
            ws = _np(sd[f"{pre}.sconv.weight"])[:, :, 0].T  # [H, C]
            g2 = _np(sd[f"{pre}.norm2.weight"])
            b2 = _np(sd[f"{pre}.norm2.bias"])
            bs = _np(sd[f"{pre}.sconv.bias"])
            wsgs.append(ws * g2[:, None])
            cs.append(np.stack([b2 @ ws + bs, g2 @ ws]))
            v = np.zeros((8, ws.shape[0]), np.float32)
            v[_B1] = _np(sd[f"{pre}.conv1x1.bias"], np.float32)
            v[_DWB] = _np(sd[f"{pre}.dwconv.bias"], np.float32)
            v[_G1] = _np(sd[f"{pre}.norm1.weight"], np.float32)
            v[_BT1] = _np(sd[f"{pre}.norm1.bias"], np.float32)
            dw = _np(sd[f"{pre}.dwconv.weight"], np.float32)  # [H, 1, 3]
            v[_DW0], v[_DW1], v[_DW2] = dw[:, 0, 0], dw[:, 0, 1], dw[:, 0, 2]
            vecs.append(v)
            alphas.append([_np(sd[f"{pre}.prelu1.weight"])[0], _np(sd[f"{pre}.prelu2.weight"])[0]])
            dils.append(2**i)

    bf, f32 = torch.bfloat16, torch.float32
    return (
        _to(np.stack(w1s), bf, device), _to(np.stack(wsgs), bf, device),
        _to(np.stack(vecs), f32, device), _to(np.stack(cs), f32, device),
        _to(np.asarray(alphas), f32, device), tuple(dils),
    )


def pack_convtasnet_full_params(state_dict, R: int, X: int, num_spks: int, device=None):
    """Pack a whole port ConvTasNet ``state_dict`` for
    ``fused_convtasnet_separator``.  The bottleneck gLN + 1x1 becomes
    pseudo-block 0 of wsgs/cs (w1s/vecs/alphas entry 0 are zeros), folded
    in f64.

    Returns (we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, dilations)."""
    sd = state_dict
    w1s, wsgs, vecs, cs, alphas, dils = pack_convtasnet_tcn_params(sd, R, X, device)
    g = _np(sd["bottleneck.0.weight"])
    bt = _np(sd["bottleneck.0.bias"])
    wbn = _np(sd["bottleneck.1.weight"])[:, :, 0].T  # [N, C]
    bbn = _np(sd["bottleneck.1.bias"])
    N, C = wbn.shape
    H = w1s.shape[2]

    bf, f32 = torch.bfloat16, torch.float32
    c0 = np.stack([bt @ wbn + bbn, g @ wbn])[None]
    w1s = torch.cat([torch.zeros((1, C, H), dtype=w1s.dtype, device=device), w1s])
    wsgs = torch.cat([_to(wbn * g[:, None], bf, device)[None], wsgs])
    vecs = torch.cat([torch.zeros((1, 8, H), dtype=vecs.dtype, device=device), vecs])
    cs = torch.cat([_to(c0, f32, device), cs])
    alphas = torch.cat([torch.zeros((1, 2), dtype=alphas.dtype, device=device), alphas])
    we = _to(_np(sd["encoder._filters"])[:, 0, :].T, bf, device)  # [win, N]
    wm = _to(_np(sd["mask.weight"])[:, :, 0].T, bf, device)  # [C, nspk*N]
    bm = _to(_np(sd["mask.bias"])[None, :], f32, device)
    wd = _to(_np(sd["decoder._filters"])[:, 0, :], bf, device)  # [N, win]
    if wm.shape != (C, num_spks * N):
        raise ValueError(f"mask weight {tuple(wm.shape)} does not match {num_spks} speakers")
    return we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, dils


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 products and sums (exact upcast, then f32 matmul)."""
    return torch.matmul(a.float(), b.float())


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _stats(x: torch.Tensor):
    """gLN mean and 1/std over (T, H) per sample: E[x^2] - mean^2, clamped."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(1, 2), keepdim=True) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + _EPS)


def tcn_chain_reference(x, w1s, wsgs, vecs, cs, alphas, dilations: Sequence[int]):
    """[B, T, C] bf16 -> [B, T, C] bf16: the packed TCN chain with the
    kernel's dtype policy (counterpart of the JAX package's
    ``ops/pallas/convtasnet_backward.py::tcn_chain_xla``).

    The taps normalise h and read zeros outside [0, T), which is the
    reference model's zero padding after gLN; the JAX oracle writes the
    same thing as folded taps with edge corrections."""
    T = x.shape[1]
    y = x.to(torch.bfloat16)
    for bi, d in enumerate(dilations):
        vec = vecs[bi]
        h = _prelu(_dot(y, w1s[bi]) + vec[_B1], alphas[bi, 0])  # f32
        mu1, r1 = _stats(h)
        sc1 = vec[_G1] * r1
        hn = h * sc1 + (vec[_BT1] - mu1 * sc1)
        down = torch.nn.functional.pad(hn, (0, 0, d, 0))[:, :T]  # hn[t-d]
        up = torch.nn.functional.pad(hn, (0, 0, 0, d))[:, d:]  # hn[t+d]
        u = vec[_DWB] + vec[_DW0] * down + vec[_DW1] * hn + vec[_DW2] * up
        v = _prelu(u, alphas[bi, 1])
        mu2, r2 = _stats(v)
        p = _dot(v.to(torch.bfloat16), wsgs[bi])
        y = (y.float() + r2 * p + (cs[bi, 0] - mu2 * r2 * cs[bi, 1])).to(torch.bfloat16)
    return y


def convtasnet_separator_reference(frames, we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd,
                                   dilations: Sequence[int], nspk: int, sigmoid: bool = False):
    """Plain PyTorch version of the whole-separator kernel, same arguments
    and result: frames [B, T', win] bf16 -> [B, nspk, T', win] bf16."""
    B, T, _ = frames.shape
    H = we.shape[1]
    enc = _dot(frames, we).to(torch.bfloat16)  # [B, T', H]
    mean, rstd = _stats(enc.float())
    y0 = rstd * _dot(enc, wsgs[0]) + (cs[0, 0] - mean * rstd * cs[0, 1])
    y = tcn_chain_reference(
        y0.to(torch.bfloat16), w1s[1:], wsgs[1:], vecs[1:], cs[1:], alphas[1:], dilations
    )
    m = _dot(y, wm) + bm[0]
    m = torch.sigmoid(m) if sigmoid else torch.relu(m)
    db = m.to(torch.bfloat16).reshape(B, T, nspk, H) * enc[:, :, None, :]
    return _dot(db.permute(0, 2, 1, 3), wd).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_TILE = 64  # frames per thread block, as in csrc/convtasnet_separator.cu


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: want {tuple(shape)} {dtype} on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_convtasnet_separator(frames, we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd,
                               dilations: Sequence[int], nspk: int, sigmoid: bool = False):
    """Whole-separator forward: encoder, bottleneck, R*X TCN blocks, mask
    head, mask*enc and decoder, from [B, T', 16] bf16 frames to
    [B, nspk, T', 16] bf16 decoder frames for ``overlap_add``.

    A CUDA tensor runs the CUDA kernel sequence (2 + 2*nb launches, added to
    ``fused_convtasnet_separator.launches``) or raises; a CPU tensor runs
    ``convtasnet_separator_reference``."""
    if frames.device.type == "cpu":
        return convtasnet_separator_reference(
            frames, we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, dilations, nspk, sigmoid
        )
    if frames.device.type != "cuda":
        raise ValueError(f"no separator kernel for device {frames.device}")
    from ._build import load_library

    dev = frames.device
    B, T, W = frames.shape
    H = we.shape[1]
    nb = len(dilations)
    if W != _WIN or H % 128 != 0 or T < 1 or nspk < 1:
        raise ValueError(f"kernel takes win={_WIN}, H % 128 == 0, T >= 1; got {W}, {H}, {T}")
    bf, f32 = torch.bfloat16, torch.float32
    _check("frames", frames, (B, T, W), bf, dev)
    _check("we", we, (W, H), bf, dev)
    _check("w1s", w1s, (nb + 1, _C, H), bf, dev)
    _check("wsgs", wsgs, (nb + 1, H, _C), bf, dev)
    _check("vecs", vecs, (nb + 1, 8, H), f32, dev)
    _check("cs", cs, (nb + 1, 2, _C), f32, dev)
    _check("alphas", alphas, (nb + 1, 2), f32, dev)
    _check("wm", wm, (_C, nspk * H), bf, dev)
    _check("bm", bm, (1, nspk * H), f32, dev)
    _check("wd", wd, (H, W), bf, dev)

    n_tiles = -(-T // _TILE)
    Tpad = n_tiles * _TILE
    out = torch.empty((B, nspk, T, W), dtype=bf, device=dev)
    enc = torch.empty((B, Tpad, H), dtype=bf, device=dev)
    y = torch.empty((B, Tpad, _C), dtype=bf, device=dev)
    h = torch.empty((B, Tpad, H), dtype=f32, device=dev)
    p = torch.empty((B, Tpad, _C), dtype=f32, device=dev)
    part1 = torch.empty((B, n_tiles, 2), dtype=f32, device=dev)
    part2 = torch.empty((B, n_tiles, 2), dtype=f32, device=dev)
    dils = (ctypes.c_int * max(nb, 1))(*dilations)

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.convtasnet_separator(
            frames.data_ptr(), we.data_ptr(), w1s.data_ptr(), wsgs.data_ptr(),
            vecs.data_ptr(), cs.data_ptr(), alphas.data_ptr(), wm.data_ptr(),
            bm.data_ptr(), wd.data_ptr(), out.data_ptr(), enc.data_ptr(), y.data_ptr(),
            h.data_ptr(), p.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            B, T, H, nb, dils, nspk, int(bool(sigmoid)), stream,
        )
    if rc != 0:
        msg = lib.convtasnet_error_string(rc).decode()
        raise RuntimeError(f"convtasnet_separator launch failed: CUDA error {rc} ({msg})")
    fused_convtasnet_separator.launches += 2 + 2 * nb
    return out


fused_convtasnet_separator.launches = 0
