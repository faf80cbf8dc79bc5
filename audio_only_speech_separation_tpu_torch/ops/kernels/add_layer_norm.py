"""The residual add and LayerNorm of a pre-norm transformer layer in one
pass (K8; ``csrc/add_layer_norm.cu``), with its plain version and its
launch counter ``add_layer_norm_launches``; ``add_layer_norm_ok`` is its
envelope.

``s = x + addend`` in x's dtype (torch's add: an f32 sum rounded once),
then ``h = F.layer_norm(s, [d], weight, bias, eps)``: the statistics of the
rounded s in f32, one rounding of h.  ``addend`` is a tensor of x's shape
(a residual branch) or a table [T, d] with x [..., T, d] (the sinusoidal
positions, broadcast over the leading axes).  ``final=True`` returns h
alone: the sum of a stack's last site feeds nothing but its final norm.

The kernel takes bf16 rows of width d with d % 8 == 0 and d <= 1024: one
warp a row, its statistics by warp shuffles, gamma and beta held in
registers across rows (see the source).  It replaces no TPU kernel: the
JAX package leaves these passes to XLA.  Only Sepformer's pre-norm stacks
call it (``models/sepformer.py``), where no gradient is recorded, so it has
no backward.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from ...utils.profiling import span
from ._build import check_launch, load_library

D_MAX = 1024

add_layer_norm_launches = SimpleNamespace(launches=0)
"""K8's launches (``launches``, a plain integer; set it to 0 to count anew)."""


def add_layer_norm_ok(d: int) -> bool:
    """Whether the kernel takes rows of width ``d``."""
    return d % 8 == 0 and 0 < d <= D_MAX


def add_layer_norm_reference(x: torch.Tensor, addend: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             eps: float, final: bool = False):
    """Plain version of ``fused_add_layer_norm``, same arguments and result:
    ``x + addend`` and ``F.layer_norm`` of it, as ``nn.LayerNorm`` runs."""
    s = x + addend
    h = F.layer_norm(s, s.shape[-1:], weight, bias, eps)
    return h if final else (s, h)


def _table_rows(x, addend) -> int:
    """0 where ``addend`` has x's shape, T where it is a [T, d] table of x's
    last two axes; raises otherwise."""
    if addend.shape == x.shape:
        return 0
    if addend.ndim == 2 and x.ndim >= 2 and addend.shape == x.shape[-2:]:
        return addend.shape[0]
    raise ValueError(f"addend must be x's shape {tuple(x.shape)} or [T, d] = {tuple(x.shape[-2:])}; "
                     f"got {tuple(addend.shape)}")


def _launch(x, addend, weight, bias, eps, final):
    """Checks, allocates and launches, with few host operations: the
    Sepformer stacks call it 68 times a request, and the host's time to
    launch a request's kernels paces the served cell.  The C entry makes
    x's device current for the launch and restores the caller's."""
    d = x.shape[-1]
    if not add_layer_norm_ok(d):
        raise ValueError(f"kernel takes d % 8 == 0, d <= {D_MAX}; got d={d}")
    table = _table_rows(x, addend)
    dev = x.get_device()
    for name, t in (("x", x), ("addend", addend), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.bfloat16 or t.get_device() != dev:
            raise ValueError(f"{name}: want bfloat16 on {x.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and start on a 16-byte boundary")
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight and bias must be [{d}]; got {tuple(weight.shape)}, {tuple(bias.shape)}")
    h = torch.empty_like(x)
    s = None if final else torch.empty_like(x)
    lib = load_library()
    # the raw handle of the device's current stream (what torch.cuda.current_stream(dev).cuda_stream gives,
    # without building a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = lib.add_layer_norm(x.data_ptr(), addend.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                            None if final else s.data_ptr(), h.data_ptr(), x.numel() // d, d, table, eps, dev, stream)
    check_launch(lib, "add_layer_norm", rc)
    add_layer_norm_launches.launches += 1
    return h if final else (s, h)


def fused_add_layer_norm(x: torch.Tensor, addend: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         eps: float, final: bool = False):
    """(s, h) = (x + addend, LayerNorm(s) with ``weight``, ``bias``,
    ``eps``), or h alone where ``final``.

    A CUDA tensor launches the kernel (one launch, added to
    ``add_layer_norm_launches``, under the span ``kernels.k8``): x, addend,
    weight and bias contiguous bf16 on x's device, 16-byte aligned, with d
    inside ``add_layer_norm_ok``, or the call raises.  A CPU tensor runs
    ``add_layer_norm_reference``; any other raises.  Records no gradient."""
    if x.is_cuda:
        with span("kernels.k8"):
            return _launch(x, addend, weight, bias, eps, final)
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, addend, weight, bias, eps, final)
    raise ValueError(f"no add-LayerNorm kernel for device {x.device}")
