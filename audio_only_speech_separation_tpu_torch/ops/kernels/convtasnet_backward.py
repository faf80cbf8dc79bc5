"""Backward of the ConvTasNet TCN chain: CUDA kernel wrapper (K3), its
plain version, and the autograd function that pairs it with the chain's
forward kernel (counterpart of
``audio_only_speech_separation_tpu/ops/pallas/convtasnet_backward.py``).

``fused_tcn_backward`` walks the blocks in reverse from the cotangent g of
the chain output.  It recomputes each block's h, u and v from the saved
block input y_b (``y_hist``) and statistics, recovers the pending product
as P = (y_{b+1} - y_b - shift) / r2, and returns the cotangent of the chain
input with the weight gradients in the packed layout (the math is in
``csrc/convtasnet_backward.cu``).  ``TCNChain`` is the chain as a
``torch.autograd.Function``: the forward kernel with ``save_state``, then
this backward.  Gradients reach the module's parameters through
``pack_convtasnet_full_params_differentiable``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ...utils.profiling import span
from .convtasnet_block import _C, _TILE, _check, fused_tcn_separator, tcn_chain_reference


def tcn_backward_reference(g, y_hist, y_fin, stats, w1s, wsgs, vecs, cs, alphas,
                           dilations: Sequence[int]):
    """Plain version of ``fused_tcn_backward``, same arguments and results:
    reruns ``tcn_chain_reference`` from the chain input y_hist[:, 0] and
    takes ``torch.autograd.grad`` of it (y_fin and stats are not needed).
    The weights enter as f32 copies, so their gradients come out in f32."""
    T = g.shape[1]
    x = y_hist[:, 0, :T].float().requires_grad_()
    leaves = [t.detach().float().requires_grad_() for t in (w1s, wsgs, vecs, cs, alphas)]
    with torch.enable_grad():
        y = tcn_chain_reference(x, *leaves, dilations)
        grads = torch.autograd.grad(y, [x, *leaves], grad_outputs=g.to(y.dtype))
    dx, dw1s, dwsgs, dvecs, dcs, dalphas = grads
    return dx.to(torch.bfloat16), dw1s, dwsgs, dvecs, dcs, dalphas


def fused_tcn_backward(g, y_hist, y_fin, stats, w1s, wsgs, vecs, cs, alphas,
                       dilations: Sequence[int]):
    """Backward of the TCN chain.  g [B, T', 128] (cotangent of the chain
    output), y_hist [B, nb, Tpad, 128] bf16, y_fin [B, T', 128] bf16 and
    stats [B, nb, 4] f32 from ``fused_tcn_separator(..., save_state=True)``,
    and the chain's packed weights.  Returns (dx [B, T', 128] bf16, dw1s
    [nb, 128, H], dwsgs [nb, H, 128], dvecs [nb, 8, H] (row 7 zero), dcs
    [nb, 2, 128], dalphas [nb, 2]), all f32 but dx.

    A CUDA tensor runs the CUDA kernel sequence (``tcn_backward_launches(nb)``
    launches, added to ``fused_tcn_backward.launches``) or raises; a CPU tensor runs
    ``tcn_backward_reference``."""
    if g.device.type == "cpu":
        return tcn_backward_reference(g, y_hist, y_fin, stats, w1s, wsgs, vecs, cs, alphas,
                                      dilations)
    if g.device.type != "cuda":
        raise ValueError(f"no TCN-backward kernel for device {g.device}")
    from ._build import check_launch, load_library

    dev = g.device
    B, T, C = g.shape
    nb, _, H = w1s.shape
    Tpad = -(-T // _TILE) * _TILE
    if C != _C or H % 128 != 0 or nb < 1 or len(dilations) != nb:
        raise ValueError(f"kernel takes C={_C}, H % 128 == 0, nb >= 1; got {C}, {H}, {nb} "
                         f"({len(dilations)} dilations)")
    bf, f32 = torch.bfloat16, torch.float32
    _check("y_hist", y_hist, (B, nb, Tpad, C), bf, dev)
    _check("y_fin", y_fin, (B, T, C), bf, dev)
    _check("stats", stats, (B, nb, 4), f32, dev)
    _check("w1s", w1s, (nb, C, H), bf, dev)
    _check("wsgs", wsgs, (nb, H, C), bf, dev)
    _check("vecs", vecs, (nb, 8, H), f32, dev)
    _check("cs", cs, (nb, 2, C), f32, dev)
    _check("alphas", alphas, (nb, 2), f32, dev)

    # the live cotangent: f32, Tpad rows, zeros past T'; updated in place
    gbuf = torch.zeros((B, Tpad, C), dtype=f32, device=dev)
    gbuf[:, :T] = g
    dw1s = torch.empty((nb, C, H), dtype=f32, device=dev)
    dwsgs = torch.empty((nb, H, C), dtype=f32, device=dev)
    dvecs = torch.empty((nb, 8, H), dtype=f32, device=dev)
    dcs = torch.empty((nb, 2, C), dtype=f32, device=dev)
    dils = (ctypes.c_int * nb)(*dilations)

    lib = load_library()
    ws = torch.empty(lib.tcn_backward_workspace_bytes(B, T, H, nb), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tcn_backward(
            gbuf.data_ptr(), y_hist.data_ptr(), y_fin.data_ptr(), stats.data_ptr(),
            w1s.data_ptr(), wsgs.data_ptr(), vecs.data_ptr(), cs.data_ptr(), alphas.data_ptr(),
            dw1s.data_ptr(), dwsgs.data_ptr(), dvecs.data_ptr(), dcs.data_ptr(), ws.data_ptr(),
            B, T, H, nb, dils, stream,
        )
    check_launch(lib, "tcn_backward", rc)
    fused_tcn_backward.launches += lib.tcn_backward_launches(nb)
    dalphas = dvecs[:, 7, :2].clone()
    dvecs[:, 7] = 0.0
    return gbuf[:, :T].to(bf), dw1s, dwsgs, dvecs, dcs, dalphas


fused_tcn_backward.launches = 0


def tcn_backward_launches(nb: int) -> int:
    """Launches of one ``fused_tcn_backward`` call over nb blocks on a CUDA
    tensor, as the library reports them (loads the library)."""
    from ._build import load_library

    return load_library().tcn_backward_launches(nb)


class TCNChain(torch.autograd.Function):
    """The TCN chain with the fused forward (``fused_tcn_separator`` with
    ``save_state``) and the fused backward (``fused_tcn_backward``)
    (counterpart of the JAX package's ``make_tcn_chain``).  CPU tensors run
    both plain versions; CUDA tensors the kernels; any other device
    raises.  The cotangents take the dtypes of their inputs (the bf16
    weight gradients are summed in f32 and rounded once)."""

    @staticmethod
    def forward(ctx, x, w1s, wsgs, vecs, cs, alphas, dilations):
        with span("kernels.k2"):
            y, y_hist, stats = fused_tcn_separator(x, w1s, wsgs, vecs, cs, alphas, dilations,
                                                   save_state=True)
        ctx.dilations = tuple(dilations)
        ctx.save_for_backward(y_hist, y, stats, w1s, wsgs, vecs, cs, alphas)
        return y

    @staticmethod
    def backward(ctx, g):
        y_hist, y, stats, w1s, wsgs, vecs, cs, alphas = ctx.saved_tensors
        with span("kernels.k3"):
            grads = fused_tcn_backward(g.contiguous(), y_hist, y, stats, w1s, wsgs, vecs, cs, alphas,
                                       ctx.dilations)
        dtypes = (torch.bfloat16, w1s.dtype, wsgs.dtype, vecs.dtype, cs.dtype, alphas.dtype)
        return (*(d.to(t) for d, t in zip(grads, dtypes)), None)


def tcn_chain(x, w1s, wsgs, vecs, cs, alphas, dilations: Sequence[int]):
    """y = the TCN chain through ``TCNChain`` (same arguments as
    ``tcn_chain_reference``)."""
    return TCNChain.apply(x, w1s, wsgs, vecs, cs, alphas, tuple(dilations))
