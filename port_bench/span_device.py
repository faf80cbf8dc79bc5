"""The device time of the work a port's span issues, for the
``device_trace`` readers of one model's stages.

``torch.profiler`` gives the host's calls into the CUDA runtime and driver
and the device's operations as separate events.  Inside each traced
request (the benchmark's ``bench.request`` span) the two pair one to one in
issue order: the program issues on one stream, so the device runs its
operations in the order the host launched them, and every request ends on
the copy of its answers to the host, which waits for the device, so no
operation of one request runs inside another's span.  An operation then
belongs to a span of the port when the host call that launched it lies
inside that span.  A request whose launches and operations do not pair one
to one (another stream, a launch the list below does not name) makes the
whole reading None.
"""

from __future__ import annotations

import bisect
from typing import Optional

REQUEST = "bench.request"
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cudaMemcpyAsync",
            "cudaMemsetAsync")


def is_launch(name: str) -> bool:
    """A host call that puts one operation on the device's queue
    (``cudaLaunchKernelExC``, ``cuLaunchKernelEx`` and the like too)."""
    return name.startswith(LAUNCHES)


def paired(trace):
    """[(host call start ns, device op duration ns)] of every operation of
    the traced requests, or None where a request's launches and operations
    do not pair one to one."""
    launches = sorted(s for n, s, _ in trace.host_ops if is_launch(n))
    device = sorted((s, e) for _, s, e in trace.device)
    device_starts = [s for s, _ in device]
    out = []
    for name, lo, hi in trace.spans:
        if name != REQUEST:
            continue
        calls = launches[bisect.bisect_left(launches, lo):bisect.bisect_right(launches, hi)]
        ops = device[bisect.bisect_left(device_starts, lo):bisect.bisect_right(device_starts, hi)]
        if len(calls) != len(ops) or not ops:
            return None
        out += [(c, e - s) for c, (s, e) in zip(calls, ops)]
    return out


def span_device_ms(ctx, name: str) -> Optional[float]:
    """The device milliseconds, a traced request, of the operations whose
    launch lies inside a span called ``name``; None without a card trace,
    without traced requests, without such a span, or where the pairing
    fails."""
    tr = ctx.trace
    n = len(ctx.read.get("traced", {}).get("requests", []))
    if tr is None or not tr.device or not n:
        return None
    spans = sorted((s, e) for m, s, e in tr.host_ops if m == name)
    if not spans:
        return None
    pairs = paired(tr)
    if pairs is None:
        return None
    starts = [s for s, _ in spans]
    total = 0
    for call, dur in pairs:
        i = bisect.bisect_right(starts, call) - 1
        if i >= 0 and call <= spans[i][1]:
            total += dur
    return total / 1e6 / n
