"""The port's span ring (``utils/profiling.py::recent_spans`` in the port)
after a ``--trace 1`` run, for the ``.unprofiled`` readers: the host's
times as the untraced part of the window ran them, with no profiler on.

Read are the ring's spans that ended before the traced stretch opened
(``ctx.trace.window[0]``, on the clock the ring shares with the
profiler), and of those the last ``ITEMS`` requests or steps: each
``serve.call`` that is its thread's outermost span (a request's root, which
the spans nested in it name as theirs), or each span of one name.  The
untraced part holds more than ``ITEMS`` of them in every cell, so the
warm-up and the checked steps fall outside.  Without a card trace, without
the ring (a program that has none), or with fewer items, a reader reads
None; so too where the mode counted fewer untraced requests or steps than
``ITEMS``, as the ring is the process's and may hold an earlier run's."""

from __future__ import annotations

from collections import defaultdict

ITEMS = 128


def untraced_items(ctx) -> int:
    """The requests or steps of the untraced part, as the mode counted them."""
    done = ctx.read.get("untraced", {})
    return len(done.get("requests", [])) or done.get("steps", 0)


def before_window(ctx):
    """The ring's spans that ended before the traced stretch opened, oldest
    first; None without a card trace, without the ring, or with fewer than
    ``ITEMS`` untraced requests or steps."""
    tr = ctx.trace
    if tr is None or not tr.device or untraced_items(ctx) < ITEMS:
        return None
    from audio_only_speech_separation_tpu_torch.utils import profiling

    recent = getattr(profiling, "recent_spans", None)
    if recent is None:
        return None
    return [s for s in recent() if s.end_ns < tr.window[0]]


def last(ctx, name: str):
    """The last ``ITEMS`` spans called ``name`` before the window, or None."""
    found = before_window(ctx)
    found = [s for s in found or () if s.name == name]
    return found[-ITEMS:] if len(found) >= ITEMS else None


def mean_ms(ctx, name: str):
    """The mean length of the last ``ITEMS`` spans called ``name``."""
    found = last(ctx, name)
    return None if found is None else sum(s.end_ns - s.start_ns for s in found) / len(found) / 1e6


def requests(ctx):
    """(the last ``ITEMS`` requests' ``serve.call`` spans, {a call's slot:
    the spans nested in it}), or None."""
    found = before_window(ctx)
    if found is None:
        return None
    calls = [s for s in found if s.name == "serve.call" and s.root == s.slot][-ITEMS:]
    if len(calls) < ITEMS:
        return None
    inside = defaultdict(list)
    slots = {c.slot for c in calls}
    for s in found:
        if s.root in slots and s.slot != s.root:
            inside[s.root].append(s)
    return calls, inside


def request_ms(ctx, names, less=()):
    """The mean over the requests of the summed spans called one of
    ``names``, less those called one of ``less``, each nested in the
    request's ``serve.call`` (``serve.call`` itself where named); None
    without the requests or without a span of ``names``."""
    got = requests(ctx)
    if got is None:
        return None
    calls, inside = got
    total, seen = 0, False
    for c in calls:
        for s in [c] + inside[c.slot]:
            if s.name in names:
                total, seen = total + s.end_ns - s.start_ns, True
            elif s.name in less:
                total -= s.end_ns - s.start_ns
    return total / len(calls) / 1e6 if seen else None


def period_ms(items) -> float:
    """The mean interval between the starts of successive ``items``."""
    return (items[-1].start_ns - items[0].start_ns) / (len(items) - 1) / 1e6


def idle_share(ctx, items, traced: int):
    """100 x (1 - the card's busy ms a traced item over the period of
    ``items``): the share of the untraced period the card idles, its work
    an item taken from the trace, where the profiler slows the host and not
    the card; None without items, trace or traced items."""
    if items is None or not traced or ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s * 1e3 / traced / period_ms(items))
