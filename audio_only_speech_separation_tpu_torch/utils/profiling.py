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
  name (``profile_trace_ops.py`` reads it);
- ``span(name)`` marks a stretch of the port's host work (``serve.*``,
  ``forward.*``, ``train.*``, ``kernels.*``, ``optim.*``,
  ``sepformer.*``, ``bsrnn.*``, ``sandglasset.*``): always in the
  process's span ring, which ``recent_spans()`` reads, and while a
  profiler records also as an event on ``torch.profiler``'s timeline.
  Both are on the profiler's clock, the one its device operations are
  put on.

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
import itertools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

RING_SLOTS = 65536  # spans the ring holds; the newest overwrite the oldest


class RingSpan(NamedTuple):
    """One finished span of the ring.  Times are ``time.time_ns()``: the
    wall clock, on which ``torch.profiler`` puts its host events and the
    device operations they launch."""

    slot: int  # the span's number in the process, counted from 0 as spans begin
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]  # the slot of the span open on the same thread when this one began
    root: int  # the slot of the outermost span open on the thread then (its own where none was)
    thread: int  # ``threading.get_ident()`` of the thread it ran on


_ring: List[Optional[tuple]] = [None] * RING_SLOTS
_slots = itertools.count()  # ``next`` on it is one C call, so two threads never draw the same slot
# ``.stack``: [the thread's ident, then (slot, event, start) of each span open on it, outermost first]
_open = threading.local()
_clock = time.time_ns
_thread = threading.get_ident


class _Span:
    """``span``'s context manager, one a name: what an open span holds lives
    on its thread's stack, so one object serves every thread and nesting.
    The ring's interval is read outside the ``record_function`` event where
    there is one: it holds the event, and so every launch of its body."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = [_thread()]
        event = None
        if _autograd_profiler._is_profiler_enabled:
            event = torch.profiler.record_function(self.name)  # made before the clock is read: less lies between
        start = _clock()
        if event is not None:
            event.__enter__()
        stack.append((next(_slots), event, start))
        return self

    def __exit__(self, *exc):
        stack = _open.stack
        slot, event, start = stack.pop()  # spans close on their thread in the reverse order of their opening
        if event is not None:
            event.__exit__(*exc)
        end = _clock()
        i = slot % RING_SLOTS
        held = _ring[i]
        if held is None or held[0] < slot:  # else RING_SLOTS spans begun since hold the ring: this one is dropped
            if len(stack) > 1:
                _ring[i] = (slot, self.name, start, end, stack[-1][0], stack[1][0], stack[0])
            else:
                _ring[i] = (slot, self.name, start, end, None, slot, stack[0])
        return False


_spans: Dict[str, _Span] = {}


def span(name: str) -> _Span:
    """A context manager over a stretch of the port's host work named
    ``<layer>.<phase>``.  It always records the stretch into the process's
    ring of ``RING_SLOTS`` spans (``recent_spans``), at under a
    microsecond of host time, and while a ``torch.profiler`` records
    (``profile_trace``, the benchmark's traced stretch) also enters
    ``torch.profiler.record_function(name)``.  Nesting on one thread gives
    a span its parent; each thread (autograd's too) nests its own.  Names
    never start with ``bench.`` or ``ProfilerStep``, which the benchmark's
    trace reader keeps for its own spans; each name keeps one object for
    the process's life."""
    got = _spans.get(name)
    if got is None:  # two threads may both make one: either serves
        got = _spans[name] = _Span(name)
    return got


def recent_spans() -> List[RingSpan]:
    """A copy of the finished spans the ring holds, oldest first: the last
    ``RING_SLOTS`` begun, less those still open."""
    held = [s for s in list(_ring) if s is not None]  # ``list`` copies the ring in one step
    held.sort()
    return [RingSpan._make(s) for s in held]


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
