"""The port's span ring (``utils/profiling.py::span``, ``recent_spans``) and
the benchmark's ``.unprofiled`` readers of it (``port_bench/ring.py``).

On the CPU: the ring wraps at ``RING_SLOTS`` and keeps the newest; a
``Server`` call, the fused inference forward and a bf16 train step give
their spans with the right parent and root slots, and a span on another
thread (autograd's, on the card) nests on that thread's own stack; slots
stay distinct and nesting right under threads that switch often; under a
CPU profiler a span's ring interval holds its ``record_function`` event,
which holds every event of its body; the eight readers on hand-built ring
contents and traces.  The card's checks of the ring against the profiler
are in ``tests/test_torch_port_tracing.py``.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_span_ring.py
"""

import sys
import threading
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
    convtasnet_separator_reference,
    pack_convtasnet_full_params,
)
from audio_only_speech_separation_tpu_torch.serve import Server
from audio_only_speech_separation_tpu_torch.train import Trainer, make_optimizer
from audio_only_speech_separation_tpu_torch.train.loggers import BaseLogger
from audio_only_speech_separation_tpu_torch.utils import profiling
from audio_only_speech_separation_tpu_torch.utils.profiling import RingSpan, recent_spans, span
from port_bench import harness, ring
from port_bench import trace as tracing

SR = 8000


def _model():
    return ConvTasNet(N=128, L=16, B=128, H=128, P=3, X=2, R=1, num_spks=2, sample_rate=SR,
                      generator=torch.Generator().manual_seed(0))


def _wavs(n=2, seconds=0.25):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(int(seconds * SR) - 7 * j).astype(np.float32) * 0.05 for j in range(n)]


def _mix():
    return torch.from_numpy(np.stack(_wavs(2, 0.25)[:1] * 2))


def _new_spans(fn, *args):
    """(what ``fn`` returned, the ring's spans begun while it ran)."""
    mark = max((s.slot for s in recent_spans()), default=-1)
    with span("test.mark"):
        pass
    first = max(s.slot for s in recent_spans())  # the mark's own slot; every later span is fn's
    assert first > mark
    out = fn(*args)
    return out, [s for s in recent_spans() if s.slot > first]


def _by_name(spans):
    out = {}
    for s in spans:
        assert s.name not in out, f"{s.name} twice"
        out[s.name] = s
    return out


def test_ring_wraps_and_keeps_the_newest():
    """RING_SLOTS + 100 spans: the ring holds the last RING_SLOTS of them,
    oldest first, every slot once."""
    n = profiling.RING_SLOTS + 100
    for _ in range(n):
        with span("test.wrap"):
            pass
    held = recent_spans()
    assert len(held) == profiling.RING_SLOTS
    slots = [s.slot for s in held]
    assert slots == sorted(slots) and len(set(slots)) == len(slots)
    assert all(s.name == "test.wrap" for s in held) and slots[-1] - slots[0] == profiling.RING_SLOTS - 1
    assert all(a.end_ns <= b.start_ns for a, b in zip(held, held[1:]))


def test_ring_drops_a_span_that_outlives_the_ring():
    """A span that closes after RING_SLOTS others began is older than all
    the ring holds: it is dropped, and overwrites none of them."""
    with span("test.long"):
        for _ in range(profiling.RING_SLOTS):
            with span("test.short"):
                pass
    held = recent_spans()
    assert len(held) == profiling.RING_SLOTS and {s.name for s in held} == {"test.short"}
    assert all(s.parent == s.root == held[0].slot - 1 for s in held)


def test_server_call_parents_and_roots():
    """A ``Server`` call (the fused dispatch, its plain separator here):
    ``serve.call`` is its thread's root; its five phases are its children;
    the fused forward's three spans are children of ``serve.forward``; all
    share the call's slot as their root and ran on this thread."""
    server = Server(_model(), use_bf16=True, device="cpu", dispatch="fused")
    out, spans = _new_spans(server, _wavs())
    assert [o.shape for o in out] == [(2, len(w)) for w in _wavs()]
    got = _by_name(spans)
    call = got["serve.call"]
    assert call.parent is None and call.root == call.slot
    for name in ("serve.pad", "serve.h2d", "serve.forward", "serve.d2h", "serve.crop"):
        assert got[name].parent == call.slot, name
    for name in ("forward.frame", "forward.separator", "forward.overlap_add"):
        assert got[name].parent == got["serve.forward"].slot, name
    assert len(spans) == 9 and all(s.root == call.slot and s.thread == threading.get_ident() for s in spans)
    assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns for s in spans)


def test_fused_inference_forward_parents_and_roots():
    """The fused inference forward called with no span open: its three
    spans are roots, in order; inside an open span they are its children."""
    model = _model()
    packed = pack_convtasnet_full_params(model.state_dict(), model.R, model.X, model.num_spks, device="cpu")
    wav = _mix().to(torch.bfloat16)
    names = ["forward.frame", "forward.separator", "forward.overlap_add"]
    _, spans = _new_spans(fused_inference_forward, model, wav, packed, convtasnet_separator_reference)
    assert [s.name for s in spans] == names
    assert all(s.parent is None and s.root == s.slot for s in spans)

    def inside():
        with span("test.outer"):
            fused_inference_forward(model, wav, packed, convtasnet_separator_reference)

    _, spans = _new_spans(inside)
    outer = spans[0]
    assert outer.name == "test.outer" and [s.name for s in spans[1:]] == names
    assert all(s.parent == s.root == outer.slot for s in spans[1:])


def _train_step(model, tmp_path, backward=lambda loss: loss.backward()):
    trainer = Trainer(str(tmp_path), precision="bfloat16", seed=0, logger=BaseLogger(), fused_forward=True,
                      device="cpu")
    module = trainer.train_module(model)
    opt = make_optimizer(model.parameters(), "adam", lr=1e-3, grad_clip=5.0)
    opt.zero_grad()
    est = module(_mix(), 0)
    backward(est.square().mean())
    opt.step()
    return est


def test_train_step_parents_and_roots(tmp_path):
    """A bf16 train step: ``train.forward`` the root of the cast, the pack
    and K2's span; ``optim.step`` the root of the clip and the update; and
    ``kernels.k3``, run here from another thread while this one holds a span
    open (autograd's own thread runs it on the card), a root on that
    thread."""
    seen = {}

    def backward_elsewhere(loss):
        def run():
            seen["thread"] = threading.get_ident()
            loss.backward()

        with span("test.held"):
            t = threading.Thread(target=run)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()

    est, spans = _new_spans(_train_step, _model(), tmp_path, backward_elsewhere)
    assert torch.isfinite(est).all()
    got = _by_name(spans)
    me = threading.get_ident()
    fwd, opt, k3 = got["train.forward"], got["optim.step"], got["kernels.k3"]
    for name in ("train.cast", "train.pack", "kernels.k2"):
        assert got[name].parent == got[name].root == fwd.slot and got[name].thread == me, name
    for name in ("optim.clip", "optim.update"):
        assert got[name].parent == got[name].root == opt.slot, name
    assert fwd.parent is None and fwd.root == fwd.slot and opt.parent is None and opt.root == opt.slot
    assert k3.parent is None and k3.root == k3.slot and k3.thread == seen["thread"] != me
    held = got["test.held"]
    assert held.start_ns <= k3.start_ns <= k3.end_ns <= held.end_ns
    assert Counter(s.name for s in spans) == Counter(
        ["train.forward", "train.cast", "train.pack", "kernels.k2", "kernels.k3", "optim.step", "optim.clip",
         "optim.update", "test.held"])


def test_threads_draw_distinct_slots_and_nest_on_their_own():
    """16 threads, each 400 spans with one nested in each, under a short
    switch interval: every slot once, and each inner span's parent and root
    the outer span its own thread opened."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    together = threading.Barrier(16, timeout=60)  # all alive at once, so no two share an ident
    try:
        def work():
            together.wait()
            for _ in range(200):
                with span("test.outer"):
                    with span("test.inner"):
                        pass

        def all_threads():
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)

        _, spans = _new_spans(all_threads)
    finally:
        sys.setswitchinterval(old)
    assert len(spans) == 16 * 400 and len({s.slot for s in spans}) == len(spans)
    by_slot = {s.slot: s for s in spans}
    inner = [s for s in spans if s.name == "test.inner"]
    assert len(inner) == 3200
    for s in inner:
        outer = by_slot[s.parent]
        assert outer.name == "test.outer" and outer.thread == s.thread and s.root == outer.slot
        assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert len({s.thread for s in spans}) == 16


def test_span_under_the_profiler_holds_its_body():
    """Under a CPU profiler a span's ring interval holds its own
    ``record_function`` event, which holds every event of its body: all on
    one clock, the event's edges within a millisecond of the ring's."""
    def body():
        with span("test.outer"):
            with torch.profiler.record_function("test.inner"):
                torch.ones(64).add_(1)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, spans = _new_spans(body)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("test.outer", "test.inner")}
    (outer,) = [s for s in spans if s.name == "test.outer"]
    ev, inner = events["test.outer"], events["test.inner"]
    assert outer.start_ns <= ev.start_ns() <= inner.start_ns() <= inner.end_ns() <= ev.end_ns() <= outer.end_ns
    assert ev.start_ns() - outer.start_ns < 1_000_000 and outer.end_ns - ev.end_ns() < 1_000_000


MS = 1_000_000  # ns
WINDOW = (10_000 * MS, 11_000 * MS)


def _request(slot, t0, call_ms=10, fwd_ms=4, d2h_ms=3, stacks=()):
    """One request's spans from ``slot`` at ``t0`` ms: a call with a
    forward and a copy out, and under the forward ``stacks``: (name, ms)."""
    call = RingSpan(slot, "serve.call", t0 * MS, (t0 + call_ms) * MS, None, slot, 1)
    fwd = RingSpan(slot + 1, "serve.forward", (t0 + 1) * MS, (t0 + 1 + fwd_ms) * MS, slot, slot, 1)
    out = [call, fwd]
    for k, (name, ms) in enumerate(stacks):
        out.append(RingSpan(slot + 2 + k, name, (t0 + 1) * MS, (t0 + 1 + ms) * MS, slot + 1, slot, 1))
    n = len(out)
    out.append(RingSpan(slot + n, "serve.d2h", (t0 + 6) * MS, (t0 + 6 + d2h_ms) * MS, slot, slot, 1))
    return out


def _serve_ring(before, warm, stacks=()):
    """``before`` requests every 12 ms ending before the window, the first
    ``warm`` (the warm-up) slower; and 5 faster requests inside the window."""
    spans, slot = [], 0
    t0 = WINDOW[0] // MS - 12 * before
    for i in range(before):
        slow = i < warm
        spans += _request(slot, t0 + 12 * i, call_ms=11 if slow else 10, fwd_ms=8 if slow else 4,
                          stacks=stacks)
        slot = spans[-1].slot + 1
    for i in range(5):
        spans += _request(slot, WINDOW[0] // MS + 100 * i, call_ms=5, fwd_ms=2, stacks=[(n, 1) for n, _ in stacks])
        slot = spans[-1].slot + 1
    return spans


def _step(slot, t0, fwd_ms=30, pack_ms=2, opt_ms=8):
    return [RingSpan(slot, "train.forward", t0 * MS, (t0 + fwd_ms) * MS, None, slot, 1),
            RingSpan(slot + 1, "train.pack", (t0 + 5) * MS, (t0 + 5 + pack_ms) * MS, slot, slot, 1),
            RingSpan(slot + 2, "kernels.k3", (t0 + 32) * MS, (t0 + 40) * MS, None, slot + 2, 2),
            RingSpan(slot + 3, "optim.step", (t0 + 41) * MS, (t0 + 41 + opt_ms) * MS, None, slot + 3, 1)]


def _train_ring(before, warm):
    """``before`` steps every 50 ms ending before the window, the first
    ``warm`` (the checked steps) slower; and 3 faster steps inside the
    window."""
    spans = []
    t0 = WINDOW[0] // MS - 50 * before
    for i in range(before):
        slow = i < warm
        spans += _step(4 * i, t0 + 50 * i, fwd_ms=45 if slow else 30, pack_ms=9 if slow else 2,
                       opt_ms=1 if slow else 8)
    for i in range(3):
        spans += _step(4 * (before + i), WINDOW[0] // MS + 100 * i, fwd_ms=60, pack_ms=6, opt_ms=20)
    return spans


def _ctx(busy_ms, requests=0, steps=0, device=True, untraced=140):
    """A reader's context: a trace over ``WINDOW`` whose card is busy
    ``busy_ms`` in it, the traced requests or steps, and as many untraced
    ones (as the mode counts them) as ``untraced``."""
    dev = [("k", WINDOW[0], WINDOW[0] + busy_ms * MS)] if device else []
    tr = tracing.Trace(device=dev, window=WINDOW)
    done = {"requests": [[SR]] * untraced} if requests else {"steps": untraced}
    return SimpleNamespace(cell=None, trace=tr, read={"traced": {"requests": [[SR]] * requests, "steps": steps},
                                                      "untraced": done})


SEPFORMER = (("sepformer.intra", 2), ("sepformer.inter", 1), ("sepformer.intra", 2), ("sepformer.inter", 1))

# metric, the ring's contents for n items, the trace's context, the value
READERS = [
    ("serve.host_ms.unprofiled", _serve_ring, dict(busy_ms=60, requests=10), 3.0),
    ("serve.forward_issue_ms.unprofiled", _serve_ring, dict(busy_ms=60, requests=10), 4.0),
    ("serve.transformer_issue_ms.unprofiled", lambda n, warm: _serve_ring(n, warm, SEPFORMER),
     dict(busy_ms=60, requests=10), 6.0),
    ("device.idle_share.serve.unprofiled", _serve_ring, dict(busy_ms=60, requests=10), 50.0),
    ("train.forward_issue_ms.unprofiled", _train_ring, dict(busy_ms=100, steps=4), 30.0),
    ("train.pack_ms.unprofiled", _train_ring, dict(busy_ms=100, steps=4), 2.0),
    ("train.optimizer_ms.unprofiled", _train_ring, dict(busy_ms=100, steps=4), 8.0),
    ("device.idle_share.train.unprofiled", _train_ring, dict(busy_ms=100, steps=4), 50.0),
]


@pytest.mark.parametrize("metric, contents, per, want", READERS, ids=[r[0] for r in READERS])
def test_ring_reader_on_hand_built_contents(monkeypatch, metric, contents, per, want):
    """The reader's value over the last 128 items before the window (the
    warm-up or checked items before them and the traced ones inside it
    left out); None with 127 items, where the mode counted 127 untraced
    items (the ring holding an earlier run's too), with no trace or a trace
    without device work, with every item inside the window, or without the
    ring."""
    reader = harness.load_reader(metric)
    read = lambda spans, **kw: (  # noqa: E731
        monkeypatch.setattr(profiling, "recent_spans", lambda: list(spans)), reader.read(_ctx(**{**per, **kw})))[1]
    assert read(contents(140, 10)) == pytest.approx(want)
    assert read(contents(128 + 3, 3)) == pytest.approx(want)
    assert read(contents(127, 0)) is None
    assert read(contents(140, 10), untraced=127) is None
    assert read(contents(140, 10), device=False) is None
    late = [s._replace(start_ns=s.start_ns + 10**12, end_ns=s.end_ns + 10**12) for s in contents(140, 10)]
    assert read(late) is None
    assert reader.read(SimpleNamespace(cell=None, trace=None, read={})) is None
    monkeypatch.delattr(profiling, "recent_spans")
    assert reader.read(_ctx(**per)) is None


def test_transformer_reader_needs_the_stack_spans(monkeypatch):
    """Requests without ``sepformer.*`` spans (another family) read None."""
    monkeypatch.setattr(profiling, "recent_spans", lambda: _serve_ring(140, 10))
    reader = harness.load_reader("serve.transformer_issue_ms.unprofiled")
    assert reader.read(_ctx(busy_ms=60, requests=10)) is None
    assert ring.requests(_ctx(busy_ms=60, requests=10))[0][0].name == "serve.call"
