"""The port's own spans (``utils/profiling.py::span`` in the port) in the
traced stretch, for the ``program_span`` readers.

A span is a host event of ``Trace.host_ops``; only spans wholly inside
the trace's window count.  A trace with no device operation is no run on
the card, and the readers read nothing from it."""

from __future__ import annotations


def total_ms(trace, name: str):
    """(count, summed milliseconds) of the spans called ``name`` inside the
    window."""
    lo, hi = trace.window
    found = [e - s for n, s, e in trace.host_ops if n == name and lo <= s and e <= hi]
    return len(found), sum(found) / 1e6


def per_item_ms(ctx, name: str, items: int, less=()):
    """The summed time of ``name`` less that of the spans ``less`` nested in
    it, over ``items`` (the traced requests or steps); None without a card
    trace, without items or without a ``name`` span."""
    tr = ctx.trace
    if tr is None or not tr.device or not items:
        return None
    n, ms = total_ms(tr, name)
    if n == 0:
        return None
    return (ms - sum(total_ms(tr, m)[1] for m in less)) / items


def traced_requests(ctx) -> int:
    return len(ctx.read.get("traced", {}).get("requests", []))


def traced_steps(ctx) -> int:
    return ctx.read.get("traced", {}).get("steps", 0)
