"""The traced stretch of a ``--trace 1`` run, read from ``torch.profiler``'s
own timeline: the device's operations (kernels, copies, sets), the
benchmark's host spans (``bench.*``) and the host's operations, all on
one clock.

- busy: the union of the device operations' intervals, so operations
  that overlap count once;
- window: the benchmark's ``bench.window`` span around the stretch;
- idle gaps: the window less the busy intervals, each labelled by the
  innermost ``bench.*`` span and the innermost host operation running at
  its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

import torch

WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::block_p1_kernel<512>(...)``
    -> ``block_p1_kernel``; any other name (a copy, a library kernel) as it is
    up to its parameters."""
    n = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    cut = min((i for i in (n.find("("), n.find("<")) if i > 0), default=len(n))
    n = n[:cut].strip()
    return n.rsplit("::", 1)[-1] if "::" in n and not n.startswith("at::") else n


@dataclass
class Trace:
    device: List[Tuple[str, int, int]] = field(default_factory=list)  # (short name, start ns, end ns)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)  # the benchmark's bench.* spans
    host_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    window: Tuple[int, int] = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return sum(min(e, hi) - max(s, lo) for s, e in self.busy_intervals() if e > lo and s < hi) / 1e9

    def device_seconds(self, names) -> float:
        """Device time of the operations whose short name is in ``names``."""
        return sum(e - s for n, s, e in self.device if n in names) / 1e9

    def top_device_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(int)
        for n, s, e in self.device:
            by[n] += e - s
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle time of the window by label ("span > host op"), the
        largest ``k``."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, min(s, hi)))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        spans = sorted(self.spans, key=lambda x: x[1])
        ops = sorted(self.host_ops, key=lambda x: x[1])
        span_starts, op_starts = [s for _, s, _ in spans], [s for _, s, _ in ops]
        by = defaultdict(int)
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) // 2
            by[f"{_innermost(spans, span_starts, mid)} > {_innermost(ops, op_starts, mid)}"] += b - a
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def _innermost(events, starts, t: int) -> str:
    """The name of the latest-starting event of ``events`` (sorted by
    start; ``starts`` their starts) that runs at ``t``, or "none"."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(events[max(0, i - 4096):i]):
        if e >= t:
            return name
    return "none"


def read(prof) -> Trace:
    """The trace of a finished ``torch.profiler.profile``."""
    tr = Trace()
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            # the device's copies of the host's annotations span whole spans, not work
            if getattr(ev, "is_user_annotation", lambda: False)() or name.startswith(("bench.", "ProfilerStep")):
                continue
            tr.device.append((short_name(name), s, e))
        elif name == WINDOW:
            tr.window = (s, e)
        elif name.startswith("bench."):
            tr.spans.append((name, s, e))
        else:
            tr.host_ops.append((name, s, e))
    return tr


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over CPU and CUDA activity; yields a holder whose
    ``trace`` is set on leaving."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Traced", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.trace = read(prof)


def span(on: bool, name: str):
    """A ``bench.<name>`` host span while tracing, nothing otherwise."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"bench.{name}")
