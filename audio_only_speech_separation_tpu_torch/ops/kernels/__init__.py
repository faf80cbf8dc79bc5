"""Hand-written CUDA kernels (sources in ``csrc/``), each beside its plain
PyTorch version and a launch counter.

The layers that call the dual-path kernels (``ops/attention.py`` and
``ops/rnn.py``) take the kernel form for a ``kernel_input`` (bf16 on a
CUDA device) inside the kernel's envelope predicate, and the plain form
otherwise: the choice is made there, before any wrapper is called.  In the
kernel form they take the kernels through ``pick``: the kernel wrapper, or
inside a ``plain_versions()`` block its plain version, on any device.  That
block is how the bf16 kernel path is compared with the same path without
the kernels; nothing enters it on its own, and a wrapper never falls back.

``grad_through_plain`` is the backward of the dual-path wrappers: autograd
through the kernel's plain version, as the JAX package's custom VJPs
recompute through their XLA forms.
"""

from __future__ import annotations

import contextlib

import torch

_plain = False


@contextlib.contextmanager
def plain_versions():
    """Within this block ``pick`` returns the plain versions."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def pick(kernel, plain):
    return plain if _plain else kernel


def kernel_input(x: torch.Tensor) -> bool:
    """Whether ``x`` is what the dual-path kernels take: bf16 on a CUDA
    device."""
    return x.is_cuda and x.dtype == torch.bfloat16


def grad_through_plain(plain, saved, needs, g):
    """Gradients of ``plain(*saved)`` against the cotangent ``g`` for the
    inputs whose ``needs`` flag is set; None for the others and for None
    inputs."""
    inputs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    with torch.enable_grad():
        out = plain(*inputs)
    wanted = [t for t in inputs if t is not None and t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, g))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in inputs)
