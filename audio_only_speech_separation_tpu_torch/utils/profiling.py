"""Parameter counts, operation and byte counts, traces and the port's
spans (counterpart of ``audio_only_speech_separation_tpu/utils/profiling.py``;
the reference measured MACs with ptflops, unit_tests.py:22,
evaluated_mac_params.py:49).

- ``count_params`` sums the module's parameter sizes, as the JAX
  package's parameter tree counts them;
- ``estimate_cost`` runs ``fn(*args)`` once under two dispatch modes:
  ``torch.utils.flop_counter.FlopCounterMode`` for the FLOPs, and a
  ``TorchDispatchMode`` that adds up every aten operation's input and
  output bytes;
- ``profile_trace`` captures a ``torch.profiler`` trace (CPU and, on the
  card, CUDA activity) for TensorBoard or a Chrome trace viewer;
- ``device_events`` sums a ``torch.profiler`` run's device operations by
  name, and ``idle_share`` reads the device's idle share of a window from
  their total (``chip_smoke.py``'s profiled phases and
  ``profile_trace_ops.py`` both read them);
- ``span(name)`` marks a stretch of the port's host work (``serve.*``,
  ``forward.*``, ``train.*``, ``kernels.*``, ``optim.*``,
  ``sepformer.*``) as an event on
  ``torch.profiler``'s timeline while a profiler records, on the clock of
  the device operations it issues; with no profiler running it costs one
  flag read and does nothing else.

The counts are not XLA's ``cost_analysis``, which the JAX package reads:

- FLOPs: ``FlopCounterMode`` counts the products (matmul, convolution,
  attention) at 2 FLOPs a multiply-add and no elementwise or reduction
  operation; XLA counts those too.  XLA also counts a ``while`` loop's
  body once, so of an LSTM's ``lax.scan`` over T steps it counts one
  step's recurrent product, where the port counts all T.  Measured on the
  CPU at small widths, the port's count is 0.86-0.96 of XLA's for
  ConvTasNet, and for TasNet-DPRNN, once the T - 1 recurrent products XLA
  leaves out are taken off, 0.94 (``tests/test_torch_port_measure.py``
  holds both within 0.85-1.0).
- bytes: the port's count is what eager PyTorch moves, every operation's
  inputs read and outputs written once, views included; XLA counts a fused
  graph, whose intermediates inside a fusion never reach memory.  So the
  port's count is the larger, by a factor that depends on how much XLA
  fuses, and the two are not compared.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import torch
from torch import nn
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager over a stretch of the port's host work named
    ``<layer>.<phase>``: ``torch.profiler.record_function(name)`` while a
    ``torch.profiler`` records (``profile_trace``, the benchmark's traced
    stretch), else one shared no-op.  Nesting on one thread gives a span
    its parent.  Names never start with ``bench.`` or ``ProfilerStep``,
    which the benchmark's trace reader keeps for its own spans."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count_params(module: nn.Module) -> int:
    """The number of parameter elements of ``module``.  An LSTM keeps
    ``nn.LSTM``'s two biases so that look2hear's checkpoints load, but its
    computation takes their sum (``ops/rnn.py``), the one bias of the JAX
    package's tree: the pair counts once."""
    from ..ops.rnn import _LSTMParams  # here, not at the top: ops/ imports this module for ``span``

    n = sum(p.numel() for p in module.parameters())
    for m in module.modules():
        if isinstance(m, _LSTMParams) and m.use_bias:
            n -= sum(getattr(m, f"bias_hh_l0{s}").numel() for s in m.suffixes)
    return n


class _ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every aten operation's tensor inputs and
    outputs (each once per operation)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def estimate_cost(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once and count its work:
    ``{"flops": products' FLOPs, "bytes_accessed": every operation's input
    and output bytes}`` (see the module docstring for how both differ from
    the JAX package's XLA counts)."""
    # imported here: the serving and training paths import this module for
    # ``span``, and this import took ≈ 0.35 s on an H100 machine's host (torch 2.11)
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    moved = _ByteCounter()
    # not under no_grad: FlopCounterMode's module tracker hooks the
    # parameters' gradient accumulators, which no_grad leaves unset
    with flops, moved:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(moved.bytes)}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (TensorBoard's trace handler): CPU activity, and CUDA activity when
    there is a card."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def device_events(prof) -> Dict[str, Tuple[float, int]]:
    """{name: (self device ms, count)} of every device operation (kernels,
    copies, memsets) a finished ``torch.profiler`` run recorded, over the
    whole run."""
    return {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def idle_share(busy_ms: float, wall_ms: float) -> float:
    """The share of a ``wall_ms`` window in which the device ran none of the
    ``busy_ms`` of its operations (``device_events``' total; operations
    taken as not overlapping)."""
    return 1.0 - busy_ms / wall_ms

