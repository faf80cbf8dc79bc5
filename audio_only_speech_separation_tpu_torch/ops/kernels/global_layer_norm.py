"""gLN over channels-last samples, with an optional residual added in the
same pass (K9; ``csrc/global_layer_norm.cu``), with its plain version and
its launch counter ``global_layer_norm_launches``;
``global_layer_norm_ok`` is its envelope.

Per sample (every axis but the batch) the statistics of
``ops/norms.py::global_moments`` (float32, shifted by the sample's first
element), ``y = bf16((x - mean) / sqrt(var + eps))``, then torch's bf16
affine ``y * weight + bias`` and, with a residual, ``residual + y``: each
a float32 operation rounded to bf16 once, as the plain path rounds them.

The kernel takes bf16 tensors [B, ..., C] with C % 8 == 0 and C <= 1024:
one statistics pass (float32 partial sums a CTA) and one apply pass that
combines them in a fixed order and writes bf16, so two device operations
a gLN (see the source).  It replaces no TPU kernel: the JAX package leaves
gLN to XLA.  ``ops/norms.py::GlobalLayerNorm`` takes it where its rule
holds (channels last, no gradient recorded), so it has no backward.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ...utils.profiling import span
from ._build import check_launch, load_library

C_MAX = 1024
VECS_A_BLOCK = 2048  # 16-byte vectors a CTA, ``VECS`` in the source

global_layer_norm_launches = SimpleNamespace(launches=0)
"""K9's gLNs (``launches``, a plain integer, two device operations each;
set it to 0 to count anew)."""


def global_layer_norm_ok(C: int) -> bool:
    """Whether the kernel takes C channels."""
    return C % 8 == 0 and 0 < C <= C_MAX


def global_layer_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                                residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``fused_global_layer_norm``, same arguments and
    result: the channels-last ``GlobalLayerNorm`` of x, then ``residual +
    y`` where a residual is given."""
    from ..norms import plain_global_layer_norm  # ops/norms.py imports this module

    y = plain_global_layer_norm(x, weight, bias, eps, channels_last=True)
    return y if residual is None else residual + y


def _launch(x, weight, bias, eps, residual):
    """Checks, allocates (y and the [B, P] float32 partials) and launches
    both passes.  The C entry makes x's device current for the launches and
    restores the caller's."""
    C = x.shape[-1]
    if x.ndim < 2 or not global_layer_norm_ok(C):
        raise ValueError(f"kernel takes [B, ..., C] with C % 8 == 0, C <= {C_MAX}; got {tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual must be x's shape {tuple(x.shape)}; got {tuple(residual.shape)}")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"weight and bias must be [{C}]; got {tuple(weight.shape)}, {tuple(bias.shape)}")
    dev = x.get_device()
    named = (("x", x), ("weight", weight), ("bias", bias), ("residual", residual))
    for name, t in named:
        if t is None:
            continue
        if t.dtype != torch.bfloat16 or t.get_device() != dev:
            raise ValueError(f"{name}: want bfloat16 on {x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    B = x.shape[0]
    n_vec = x.numel() // B // 8 if B else 0
    blocks = B * -(-n_vec // VECS_A_BLOCK)
    if n_vec >= 2 ** 31 or blocks >= 2 ** 31:
        raise ValueError(f"kernel takes fewer than 2^31 vectors a sample and CTAs; got {tuple(x.shape)}")
    y = torch.empty_like(x)
    partials = torch.empty(2 * blocks, device=x.device, dtype=torch.float32)
    lib = load_library()
    # the raw handle of the device's current stream (what torch.cuda.current_stream(dev).cuda_stream gives,
    # without building a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = lib.global_layer_norm(x.data_ptr(), None if residual is None else residual.data_ptr(), weight.data_ptr(),
                               bias.data_ptr(), partials.data_ptr(), blocks, y.data_ptr(), B, n_vec, C, eps, dev,
                               stream)
    check_launch(lib, "global_layer_norm", rc)
    global_layer_norm_launches.launches += 1
    return y


def fused_global_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                            residual: torch.Tensor | None = None) -> torch.Tensor:
    """The channels-last gLN of x [B, ..., C] with ``weight``, ``bias``,
    ``eps``, plus ``residual`` where given.

    A CUDA tensor launches the kernel (one gLN, added to
    ``global_layer_norm_launches``, under the span ``kernels.k9``): x,
    residual, weight and bias contiguous bf16 on x's device, 16-byte
    aligned, with C inside ``global_layer_norm_ok``, or the call raises.  A
    CPU tensor runs ``global_layer_norm_reference``; any other raises.
    Records no gradient."""
    if x.is_cuda:
        with span("kernels.k9"):
            return _launch(x, weight, bias, eps, residual)
    if x.device.type == "cpu":
        return global_layer_norm_reference(x, weight, bias, eps, residual)
    raise ValueError(f"no gLN kernel for device {x.device}")
