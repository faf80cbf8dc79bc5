"""ConvTasNet forward kernels: the whole separator (K1) and the TCN chain
of training (K2), their CUDA wrappers and plain versions, and the weight
packers (counterpart of
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

The TCN chain alone (step 3 on [B, T', 128] bf16, ``fused_tcn_separator``)
is the forward of training; with ``save_state`` it also returns each
block's input (``y_hist``) and gLN statistics for the backward
(``convtasnet_backward.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

# vecs packing rows (f32 [nb, 8, H]); row 7 is unused padding
_B1, _DWB, _G1, _BT1, _DW0, _DW1, _DW2 = range(7)
_EPS = 1e-8
_C = 128  # bottleneck channels the kernel takes
_WIN = 16  # filter length the kernel takes
_TILE = 64  # frames per thread block, as in csrc/convtasnet_common.cuh
_H_MAX = 640  # the block body holds all of W1^T in shared memory
_SUB = 64  # hidden channels per sub-chunk of the block body's products


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


def pack_convtasnet_full_params_differentiable(params, R: int, X: int, num_spks: int):
    """``pack_convtasnet_full_params`` as differentiable torch ops, for
    training (counterpart of the JAX package's
    ``pack_convtasnet_full_params_jnp``): the folds run in f32 from
    ``params`` (``{state_dict name: tensor}``, any float dtype, e.g. the
    bf16 casts of a module's parameters), so autograd carries gradients of
    the packed layout back to them.  Same return layout, on the params'
    device."""
    bf, f32 = torch.bfloat16, torch.float32

    def p(name):
        return params[name].to(f32)

    w1s, wsgs, vecs, cs, alphas, dils = [], [], [], [], [], []
    for r in range(R):
        for i in range(X):
            pre = f"separation.sep.{r}.tcn.{i}"
            w1s.append(p(f"{pre}.conv1x1.weight")[:, :, 0].t())  # [C, H]
            ws = p(f"{pre}.sconv.weight")[:, :, 0].t()  # [H, C]
            g2, b2 = p(f"{pre}.norm2.weight"), p(f"{pre}.norm2.bias")
            wsgs.append(ws * g2[:, None])
            cs.append(torch.stack([b2 @ ws + p(f"{pre}.sconv.bias"), g2 @ ws]))
            dw = p(f"{pre}.dwconv.weight")  # [H, 1, 3]
            # rows in _B1/_DWB/_G1/_BT1/_DW0/_DW1/_DW2 order; row 7 is padding
            vecs.append(torch.stack([
                p(f"{pre}.conv1x1.bias"), p(f"{pre}.dwconv.bias"),
                p(f"{pre}.norm1.weight"), p(f"{pre}.norm1.bias"),
                dw[:, 0, 0], dw[:, 0, 1], dw[:, 0, 2], torch.zeros_like(dw[:, 0, 0]),
            ]))
            alphas.append(torch.cat([p(f"{pre}.prelu1.weight"), p(f"{pre}.prelu2.weight")]))
            dils.append(2**i)

    g, bt = p("bottleneck.0.weight"), p("bottleneck.0.bias")
    wbn = p("bottleneck.1.weight")[:, :, 0].t()  # [N, C]
    C, H = w1s[0].shape
    zeros = functools.partial(torch.zeros, dtype=f32, device=wbn.device)
    w1s = torch.cat([zeros((1, C, H)), torch.stack(w1s)]).to(bf)
    wsgs = torch.cat([(wbn * g[:, None])[None], torch.stack(wsgs)]).to(bf)
    vecs = torch.cat([zeros((1, 8, H)), torch.stack(vecs)])
    cs = torch.cat([torch.stack([bt @ wbn + p("bottleneck.1.bias"), g @ wbn])[None], torch.stack(cs)])
    alphas = torch.cat([zeros((1, 2)), torch.stack(alphas)])
    we = p("encoder._filters")[:, 0, :].t().to(bf)  # [win, N]
    wm = p("mask.weight")[:, :, 0].t().to(bf)  # [C, nspk*N]
    bm = p("mask.bias")[None, :]
    wd = p("decoder._filters")[:, 0, :].to(bf)  # [N, win]
    if wm.shape != (C, num_spks * wbn.shape[0]):
        raise ValueError(f"mask weight {tuple(wm.shape)} does not match {num_spks} speakers")
    return we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, tuple(dils)


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


def _block_reference(y, w1, wsg, vec, c, alpha, d: int):
    """One TCN block on bf16 y [B, T, C]: (next y in bf16, the block's
    (mean1, rstd1, mean2, rstd2), each [B, 1, 1] f32)."""
    T = y.shape[1]
    h = _prelu(_dot(y, w1) + vec[_B1], alpha[0])  # f32
    mu1, r1 = _stats(h)
    sc1 = vec[_G1] * r1
    hn = h * sc1 + (vec[_BT1] - mu1 * sc1)
    down = torch.nn.functional.pad(hn, (0, 0, d, 0))[:, :T]  # hn[t-d]
    up = torch.nn.functional.pad(hn, (0, 0, 0, d))[:, d:]  # hn[t+d]
    u = vec[_DWB] + vec[_DW0] * down + vec[_DW1] * hn + vec[_DW2] * up
    v = _prelu(u, alpha[1])
    mu2, r2 = _stats(v)
    p = _dot(v.to(torch.bfloat16), wsg)
    y = (y.float() + r2 * p + (c[0] - mu2 * r2 * c[1])).to(torch.bfloat16)
    return y, (mu1, r1, mu2, r2)


def _block_split_reference(y, w1, wsg, vec, c, alpha, d: int, tile: int = _TILE):
    """``_block_reference`` computed the way the CUDA kernels split it, as a
    CPU oracle of that split (nothing on the main path calls it):

    1. a statistics pass (block_p1_kernel): per ``tile`` rows, h = PReLU(y
       @ W1 + b1) only for per-tile (sum, sum of squares) partials of the
       rows < T, summed in tile order; no h is kept;
    2. a tap pass (block_p2_kernel): per tile, h recomputed from y in the
       three windows of rows t - d, t, t + d, normalised, and zeroed where
       the row lies outside [0, T); u, v, v's per-tile partials and the
       pending product, as the kernel does them.

    Same arguments and results as ``_block_reference``."""
    B, T, _ = y.shape
    H = w1.shape[1]
    starts = range(0, T, tile)

    def h_at(rows):  # h at rows (any ints) from y; rows outside [0, T) read zero input
        ok = (rows >= 0) & (rows < T)
        yr = torch.zeros((B, len(rows), y.shape[2]), dtype=y.dtype)
        yr[:, ok] = y[:, rows[ok]]
        return _prelu(_dot(yr, w1) + vec[_B1], alpha[0]), ok[None, :, None]

    def finish(parts):  # mean and 1/std from per-tile (sum, sumsq) partials, in order
        s = q = 0.0
        for ps, pq in parts:
            s, q = s + ps, q + pq
        mean = s / (T * H)
        return mean, torch.rsqrt(torch.clamp(q / (T * H) - mean * mean, min=0.0) + _EPS)

    def part(x):
        return x.sum(dim=(1, 2), keepdim=True), (x * x).sum(dim=(1, 2), keepdim=True)

    mu1, r1 = finish([part(h_at(torch.arange(t0, min(t0 + tile, T)))[0]) for t0 in starts])
    sc1 = vec[_G1] * r1
    sh1 = vec[_BT1] - mu1 * sc1
    vs = []
    for t0 in starts:
        rows = torch.arange(t0, min(t0 + tile, T))
        u = vec[_DWB]
        for k, dw in zip((-1, 0, 1), (_DW0, _DW1, _DW2)):
            h, ok = h_at(rows + k * d)
            u = u + vec[dw] * torch.where(ok, h * sc1 + sh1, 0.0)
        vs.append(_prelu(u, alpha[1]))
    mu2, r2 = finish([part(v) for v in vs])
    p = _dot(torch.cat(vs, dim=1).to(torch.bfloat16), wsg)
    y = (y.float() + r2 * p + (c[0] - mu2 * r2 * c[1])).to(torch.bfloat16)
    return y, (mu1, r1, mu2, r2)


def tcn_chain_reference(x, w1s, wsgs, vecs, cs, alphas, dilations: Sequence[int]):
    """[B, T, C] bf16 -> [B, T, C] bf16: the packed TCN chain with the
    kernel's dtype policy (counterpart of the JAX package's
    ``ops/pallas/convtasnet_backward.py::tcn_chain_xla``).  Differentiable:
    autograd of it is the plain version of the chain's backward.

    The taps normalise h and read zeros outside [0, T), which is the
    reference model's zero padding after gLN; the JAX oracle writes the
    same thing as folded taps with edge corrections."""
    y = x.to(torch.bfloat16)
    for bi, d in enumerate(dilations):
        y, _ = _block_reference(y, w1s[bi], wsgs[bi], vecs[bi], cs[bi], alphas[bi], d)
    return y


def tcn_separator_reference(x, w1s, wsgs, vecs, cs, alphas, dilations: Sequence[int],
                            save_state: bool = False):
    """Plain version of the TCN-chain kernel (``fused_tcn_separator``), same
    arguments and results: ``tcn_chain_reference`` and, with
    ``save_state``, y_hist [B, nb, Tpad, C] bf16 (each block's input, rows
    >= T zero, Tpad = T rounded up to 64) and stats [B, nb, 4] f32 (each
    block's mean1, rstd1, mean2, rstd2)."""
    B, T, C = x.shape
    y = x.to(torch.bfloat16)
    hist, stats = [], []
    for bi, d in enumerate(dilations):
        hist.append(y)
        y, st = _block_reference(y, w1s[bi], wsgs[bi], vecs[bi], cs[bi], alphas[bi], d)
        stats.append(torch.cat([s.reshape(B, 1) for s in st], dim=1))
    if not save_state:
        return y
    Tpad = -(-T // _TILE) * _TILE
    y_hist = torch.zeros((B, len(dilations), Tpad, C), dtype=torch.bfloat16, device=x.device)
    y_hist[:, :, :T] = torch.stack(hist, dim=1)
    return y, y_hist, torch.stack(stats, dim=1)


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
# The kernels
# ---------------------------------------------------------------------------


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(
            f"{name}: want {tuple(shape)} {dtype} on {device}, "
            f"got {tuple(t.shape)} {t.dtype} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_aligned(name, t):
    """Kernels that read with 16-byte copies take 16-byte aligned tensors."""
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def block_kernel_ok(H: int, C: int = _C, win: int = _WIN) -> bool:
    """Whether the TCN block body of K1 and K2 takes hidden width ``H``,
    bottleneck ``C`` and filter length ``win``: H a multiple of 128 up to
    ``_H_MAX`` (all of W1^T sits in shared memory), C 128, win 16."""
    return H % 128 == 0 and 0 < H <= _H_MAX and C == _C and win == _WIN


def _core_w1(w1s: torch.Tensor) -> torch.Tensor:
    """W1 [nb, 128, H] -> W1^T in the block body's wgmma operand layout:
    per sub-chunk of 64 hidden channels (rows n) a [64, 128] tile cut into
    8 x 8 core matrices, the contraction dimension (k) fastest, so that one
    bulk copy stages a sub-chunk (csrc/convtasnet_separator.cu, core_index)."""
    nb, C, H = w1s.shape
    return w1s.view(nb, C // 8, 8, H // _SUB, _SUB // 8, 8).permute(0, 3, 4, 1, 5, 2).contiguous()


def _core_wsg(wsgs: torch.Tensor) -> torch.Tensor:
    """wsg [nb, H, 128] -> wsg^T in the same layout: per sub-chunk of 64
    hidden channels (now k) a [128, 64] tile of core matrices."""
    nb, H, C = wsgs.shape
    return wsgs.view(nb, H // _SUB, _SUB // 8, 8, C // 8, 8).permute(0, 1, 4, 2, 5, 3).contiguous()


def fused_convtasnet_separator(frames, we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd,
                               dilations: Sequence[int], nspk: int, sigmoid: bool = False):
    """Whole-separator forward: encoder, bottleneck, R*X TCN blocks, mask
    head, mask*enc and decoder, from [B, T', 16] bf16 frames to
    [B, nspk, T', 16] bf16 decoder frames for ``overlap_add``.

    A CUDA tensor runs the CUDA kernel sequence
    (``convtasnet_separator_launches(nb)`` launches, added to
    ``fused_convtasnet_separator.launches``) or raises; a CPU tensor runs
    ``convtasnet_separator_reference``.  No [B, Tpad, H] hidden state is
    allocated: the kernels recompute h from each block's bf16 input."""
    if frames.device.type == "cpu":
        return convtasnet_separator_reference(
            frames, we, w1s, wsgs, vecs, cs, alphas, wm, bm, wd, dilations, nspk, sigmoid
        )
    if frames.device.type != "cuda":
        raise ValueError(f"no separator kernel for device {frames.device}")
    from ._build import check_launch, load_library

    dev = frames.device
    B, T, W = frames.shape
    H = we.shape[1]
    nb = len(dilations)
    if not block_kernel_ok(H, win=W) or T < 1 or nspk < 1:
        raise ValueError(f"kernel takes win={_WIN}, H % 128 == 0, H <= {_H_MAX}, T >= 1; "
                         f"got {W}, {H}, {T}")
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
    p = torch.empty((B, Tpad, _C), dtype=f32, device=dev)
    part1 = torch.empty((B, n_tiles, 2), dtype=f32, device=dev)
    part2 = torch.empty((B, n_tiles, 2), dtype=f32, device=dev)
    dils = (ctypes.c_int * max(nb, 1))(*dilations)

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        w1c, wsgc = _core_w1(w1s), _core_wsg(wsgs)
        rc = lib.convtasnet_separator(
            frames.data_ptr(), we.data_ptr(), w1c.data_ptr(), wsgs.data_ptr(), wsgc.data_ptr(),
            vecs.data_ptr(), cs.data_ptr(), alphas.data_ptr(), wm.data_ptr(),
            bm.data_ptr(), wd.data_ptr(), out.data_ptr(), enc.data_ptr(), y.data_ptr(),
            p.data_ptr(), part1.data_ptr(), part2.data_ptr(),
            B, T, H, nb, dils, nspk, int(bool(sigmoid)), stream,
        )
    check_launch(lib, "convtasnet_separator", rc)
    fused_convtasnet_separator.launches += lib.convtasnet_separator_launches(nb)
    return out


fused_convtasnet_separator.launches = 0


def fused_tcn_separator(x, w1s, wsgs, vecs, cs, alphas, dilations: Sequence[int],
                        save_state: bool = False):
    """The TCN chain, the forward of training: x [B, T', 128] bf16 -> y
    [B, T', 128] bf16; with ``save_state`` also y_hist [B, nb, Tpad, 128]
    bf16 and stats [B, nb, 4] f32 (see ``tcn_separator_reference``).

    A CUDA tensor runs the CUDA kernel sequence
    (``tcn_separator_launches(nb)`` launches, added to
    ``fused_tcn_separator.launches``; the state is kept either way) or
    raises; a CPU tensor runs ``tcn_separator_reference``.  As in the
    separator, no [B, Tpad, H] hidden state is allocated."""
    if x.device.type == "cpu":
        return tcn_separator_reference(x, w1s, wsgs, vecs, cs, alphas, dilations, save_state)
    if x.device.type != "cuda":
        raise ValueError(f"no TCN-chain kernel for device {x.device}")
    from ._build import check_launch, load_library

    dev = x.device
    B, T, C = x.shape
    nb, _, H = w1s.shape
    if not block_kernel_ok(H, C=C) or T < 1 or nb < 1 or len(dilations) != nb:
        raise ValueError(f"kernel takes C={_C}, H % 128 == 0, H <= {_H_MAX}, T >= 1, nb >= 1; "
                         f"got {C}, {H}, {T}, {nb} ({len(dilations)} dilations)")
    bf, f32 = torch.bfloat16, torch.float32
    _check("x", x, (B, T, C), bf, dev)
    _check("w1s", w1s, (nb, C, H), bf, dev)
    _check("wsgs", wsgs, (nb, H, C), bf, dev)
    _check("vecs", vecs, (nb, 8, H), f32, dev)
    _check("cs", cs, (nb, 2, C), f32, dev)
    _check("alphas", alphas, (nb, 2), f32, dev)

    n_tiles = -(-T // _TILE)
    Tpad = n_tiles * _TILE
    y = torch.empty((B, T, C), dtype=bf, device=dev)
    y_hist = torch.empty((B, nb, Tpad, C), dtype=bf, device=dev)
    stats = torch.empty((B, nb, 4), dtype=f32, device=dev)
    p = torch.empty((B, Tpad, C), dtype=f32, device=dev)
    part1 = torch.empty((B, n_tiles, 2), dtype=f32, device=dev)
    part2 = torch.empty((B, n_tiles, 2), dtype=f32, device=dev)
    dils = (ctypes.c_int * nb)(*dilations)

    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        w1c, wsgc = _core_w1(w1s), _core_wsg(wsgs)
        rc = lib.tcn_separator(
            x.data_ptr(), w1c.data_ptr(), wsgc.data_ptr(), vecs.data_ptr(), cs.data_ptr(),
            alphas.data_ptr(), y.data_ptr(), y_hist.data_ptr(), stats.data_ptr(),
            p.data_ptr(), part1.data_ptr(), part2.data_ptr(), B, T, H, nb, dils, stream,
        )
    check_launch(lib, "tcn_separator", rc)
    fused_tcn_separator.launches += lib.tcn_separator_launches(nb)
    return (y, y_hist, stats) if save_state else y


fused_tcn_separator.launches = 0


def convtasnet_separator_launches(nb: int) -> int:
    """Launches of one ``fused_convtasnet_separator`` call over nb blocks on
    a CUDA tensor, as the library reports them (loads the library)."""
    from ._build import load_library

    return load_library().convtasnet_separator_launches(nb)


def tcn_separator_launches(nb: int) -> int:
    """Launches of one ``fused_tcn_separator`` call over nb blocks on a
    CUDA tensor, as the library reports them (loads the library)."""
    from ._build import load_library

    return load_library().tcn_separator_launches(nb)
