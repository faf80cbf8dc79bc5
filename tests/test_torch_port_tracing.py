"""The port's spans (``utils/profiling.py::span``) and the benchmark's
readers of them.

On the CPU: with no profiler running a span never enters
``record_function`` and the port's span ring gains exactly the spans run;
under ``torch.profiler`` a ``Server`` call, the
fused inference forward, and a bf16 train step through the TCN chain's
kernels (their plain versions here) give each span once, nested as the
layers call each other, with the parameters' one bf16 rounding inside
``train.pack``; the five ``program_span`` readers of ``port_bench`` on
hand-built traces; ``port_bench.launches``' tally of a train step's
launches by phase, on a hand-built trace and on the train cell at its CPU
widths; a small Sepformer's ``sepformer.intra`` and ``sepformer.inter``
spans, one a stack.  On the card (marker ``cuda``): a traced run of each
cell reads the metrics of its own, and no span is counted as device work;
``kernels.k4`` once a transformer layer, inside its stack's span; a 10 s
traced run of each cell reads every ``.unprofiled`` metric of its own, and
in its traced stretch each ring span holds its ``record_function`` event
(the two clocks within 50 µs) and the launch calls the profiler puts in
that event.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_tracing.py
"""

import json
import math
from collections import Counter, defaultdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_only_speech_separation_tpu_torch.models import ConvTasNet, Sepformer
from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
    convtasnet_separator_reference,
    pack_convtasnet_full_params,
)
from audio_only_speech_separation_tpu_torch.serve import Server
from audio_only_speech_separation_tpu_torch.train import Trainer, make_optimizer
from audio_only_speech_separation_tpu_torch.train.loggers import BaseLogger
from audio_only_speech_separation_tpu_torch.utils import profiling
from port_bench import harness, launches
from port_bench import run as bench_run
from port_bench import trace as tracing
from port_bench.tests.small import small_cell

PROGRAM = ("serve.", "forward.", "train.", "kernels.", "optim.", "sepformer.")
METRICS = ("serve.host_ms", "serve.forward_issue_ms", "train.forward_issue_ms", "train.optimizer_ms",
           "train.pack_ms")
SR = 8000


def _model():
    """A ConvTasNet inside the fused kernels' envelope, at a small width."""
    return ConvTasNet(N=128, L=16, B=128, H=128, P=3, X=2, R=1, num_spks=2, sample_rate=SR,
                      generator=torch.Generator().manual_seed(0))


def _sepformer():
    """A Sepformer of 2 dual blocks, each stack 2 layers of 4 heads of 8."""
    return Sepformer(encoder_out_nchannels=32, masknet_chunksize=20, intra_numlayers=2, inter_numlayers=2,
                     intra_nhead=4, inter_nhead=4, intra_dffn=64, inter_dffn=64, sample_rate=SR,
                     generator=torch.Generator().manual_seed(0)).eval()


def _sepformer_call(model, device="cpu", dtype=torch.float32):
    wav = torch.from_numpy(np.stack(_wavs(2, 0.25)[:1] * 2)).to(device=device, dtype=dtype)
    with torch.no_grad():
        return model(wav)


def _wavs(n=2, seconds=0.25):
    rng = np.random.default_rng(0)
    return [rng.standard_normal(int(seconds * SR) - 7 * j).astype(np.float32) * 0.05 for j in range(n)]


def _server_call(model):
    server = Server(model, use_bf16=True, device="cpu", dispatch="fused")
    return server(_wavs())


def _train_step(model, tmp_path):
    """One bf16 step through ``make_kernel_train_apply`` (K2/K3's plain
    versions on the CPU) and the clipped Adam, as ``Trainer.fit`` steps."""
    trainer = Trainer(str(tmp_path), precision="bfloat16", seed=0, logger=BaseLogger(), fused_forward=True,
                      device="cpu")
    module = trainer.train_module(model)
    opt = make_optimizer(model.parameters(), "adam", lr=1e-3, grad_clip=5.0)
    mix = torch.from_numpy(np.stack(_wavs(2, 0.25)[:1] * 2))
    opt.zero_grad()
    est = module(mix, 0)
    est.square().mean().backward()
    opt.step()
    return est


def _spans(prof):
    """{name: [(start ns, end ns)]} of the port's spans in a finished profile."""
    out = defaultdict(list)
    for name, s, e in tracing.read(prof).host_ops:
        if name.startswith(PROGRAM):
            out[name].append((s, e))
    return out


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return _spans(prof)


def _refuse(name, *args, **kwargs):
    raise AssertionError(f"record_function({name!r}) entered with no profiler running")


def _ring_gain(fn, *args):
    """(what ``fn`` returned, {name: count} of the spans the port's span ring
    gained while it ran)."""
    before = max((s.slot for s in profiling.recent_spans()), default=-1)
    out = fn(*args)
    return out, Counter(s.name for s in profiling.recent_spans() if s.slot > before)


def test_no_profiler_no_record_function(monkeypatch, tmp_path):
    """(a) Outside a profiler neither a ``Server`` call nor a train step
    with the optimizer enters ``record_function``, and each adds exactly its
    own spans to the port's span ring: the call its nine, the step its
    eight."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    out, gained = _ring_gain(_server_call, _model())
    assert [o.shape for o in out] == [(2, len(w)) for w in _wavs()]
    assert gained == Counter(["serve.call", "serve.pad", "serve.h2d", "serve.forward", "forward.frame",
                              "forward.separator", "forward.overlap_add", "serve.d2h", "serve.crop"])
    est, gained = _ring_gain(_train_step, _model(), tmp_path)
    assert torch.isfinite(est).all()
    assert gained == Counter(["train.forward", "train.cast", "train.pack", "kernels.k2", "kernels.k3",
                              "optim.step", "optim.clip", "optim.update"])


def test_sepformer_spans_off_the_profiler(monkeypatch):
    """Off the profiler a Sepformer forward never enters ``record_function``,
    and the port's span ring gains its two dual blocks' stack spans and
    nothing else (no attention takes K4 on the CPU)."""
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    out, gained = _ring_gain(_sepformer_call, _sepformer())
    assert torch.isfinite(out).all()
    assert gained == Counter({"sepformer.intra": 2, "sepformer.inter": 2})


def test_sepformer_stack_spans():
    """Under the profiler each dual block's intra and inter stacks give one
    ``sepformer.intra`` and one ``sepformer.inter`` span, in the order the
    blocks run them, and nothing else of the port's; on the CPU no
    attention takes K4, so no ``kernels.k4``."""
    spans = _profiled(_sepformer_call, _sepformer())
    assert sorted(spans) == ["sepformer.inter", "sepformer.intra"], dict(spans)
    assert len(spans["sepformer.intra"]) == len(spans["sepformer.inter"]) == 2
    order = sorted(spans["sepformer.intra"] + spans["sepformer.inter"])
    assert order[0::2] == sorted(spans["sepformer.intra"]) and order[1::2] == sorted(spans["sepformer.inter"])
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def test_server_call_spans_in_order():
    """(b) One ``Server`` call: one ``serve.call`` holding the pad, the copy
    in, the forward, the copy out and the crop, in that order, and the fused
    forward's three spans inside ``serve.forward``."""
    spans = _profiled(_server_call, _model())
    phases = ["serve.pad", "serve.h2d", "serve.forward", "serve.d2h", "serve.crop"]
    assert len(spans["serve.call"]) == 1 and all(len(spans[p]) == 1 for p in phases), dict(spans)
    call = spans["serve.call"][0]
    got = [spans[p][0] for p in phases]
    assert all(_within(g, call) for g in got)
    assert all(a[1] <= b[0] for a, b in zip(got, got[1:])), got
    for name in ("forward.frame", "forward.separator", "forward.overlap_add"):
        assert len(spans[name]) == 1 and _within(spans[name][0], spans["serve.forward"][0])


def test_fused_inference_forward_spans():
    """(b) The fused inference forward with the plain separator: frame,
    separator and overlap-add, once each and in that order."""
    model = _model()
    packed = pack_convtasnet_full_params(model.state_dict(), model.R, model.X, model.num_spks, device="cpu")
    wav = torch.from_numpy(np.stack(_wavs(2, 0.25)[:1] * 2)).to(torch.bfloat16)
    spans = _profiled(fused_inference_forward, model, wav, packed, convtasnet_separator_reference)
    names = ["forward.frame", "forward.separator", "forward.overlap_add"]
    assert sorted(spans) == sorted(names), dict(spans)
    got = [spans[n][0] for n in names]
    assert all(len(spans[n]) == 1 for n in names) and all(a[1] <= b[0] for a, b in zip(got, got[1:]))


def test_train_step_spans(tmp_path):
    """(b) A bf16 train step: ``train.forward`` holding ``train.cast`` and
    ``train.pack``, K2's and K3's spans once each, and ``optim.step``
    holding the clip and the update."""
    spans = _profiled(_train_step, _model(), tmp_path)
    once = ["train.forward", "train.cast", "train.pack", "kernels.k2", "kernels.k3", "optim.step",
            "optim.clip", "optim.update"]
    assert all(len(spans[n]) == 1 for n in once), dict(spans)
    assert not any(n.startswith("serve.") or n.startswith("forward.") for n in spans)
    fwd, opt = spans["train.forward"][0], spans["optim.step"][0]
    assert all(_within(spans[n][0], fwd) for n in ("train.cast", "train.pack", "kernels.k2"))
    assert not _within(spans["kernels.k3"][0], fwd) and fwd[1] <= spans["kernels.k3"][0][0] <= opt[0]
    clip, update = spans["optim.clip"][0], spans["optim.update"][0]
    assert _within(clip, opt) and _within(update, opt) and clip[1] <= update[0]


def test_train_step_rounds_the_leaves_in_the_pack(tmp_path):
    """(b) On the fused train step ``train.pack`` holds the parameters' bf16
    rounding, one cast of all of them as one flat tensor, and ``train.cast``
    (once, inside ``train.forward``) casts the mix alone."""
    model = _model()
    n = sum(p.numel() for p in model.parameters())
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        _train_step(model, tmp_path)
    events = prof.events()

    def inside(name):
        (span,) = [e for e in events if e.name == name]
        lo, hi = span.time_range.start, span.time_range.end
        return [e for e in events if e.name == "aten::_to_copy" and lo <= e.time_range.start and e.time_range.end <= hi]

    assert [e.input_shapes[0] for e in inside("train.cast")] == [[1 * 2, int(0.25 * SR)]]
    assert [n] in [e.input_shapes[0] for e in inside("train.pack")]


MS = 1_000_000  # ns


def _ctx(host_ops, requests=0, steps=0, device=True):
    """A reader's context over a hand-built trace: window [100, 1000] ms."""
    tr = tracing.Trace(device=[("k", 100 * MS, 101 * MS)] if device else [], host_ops=host_ops,
                       window=(100 * MS, 1000 * MS))
    return SimpleNamespace(cell=None, trace=tr, read={"traced": {"requests": [[SR]] * requests, "steps": steps}})


def _serve_ops(t0):
    """One request at ``t0`` ms: a 10 ms call with a 4 ms forward and a 3 ms
    copy out."""
    return [("serve.call", t0 * MS, (t0 + 10) * MS), ("serve.pad", t0 * MS, (t0 + 1) * MS),
            ("serve.forward", (t0 + 2) * MS, (t0 + 6) * MS), ("serve.d2h", (t0 + 6) * MS, (t0 + 9) * MS)]


def _train_ops(t0):
    return [("train.forward", t0 * MS, (t0 + 30) * MS), ("train.cast", t0 * MS, (t0 + 5) * MS),
            ("train.pack", (t0 + 20) * MS, (t0 + 22) * MS),
            ("optim.step", (t0 + 70) * MS, (t0 + 78) * MS), ("optim.clip", (t0 + 70) * MS, (t0 + 72) * MS)]


@pytest.mark.parametrize("metric, ops, per, want", [
    ("serve.host_ms", _serve_ops(200) + _serve_ops(300), {"requests": 2}, 3.0),
    ("serve.forward_issue_ms", _serve_ops(200) + _serve_ops(300), {"requests": 2}, 4.0),
    ("train.forward_issue_ms", _train_ops(200) + _train_ops(400), {"steps": 2}, 30.0),
    ("train.optimizer_ms", _train_ops(200) + _train_ops(400), {"steps": 2}, 8.0),
    ("train.pack_ms", _train_ops(200) + _train_ops(400), {"steps": 2}, 2.0),
])
def test_readers_on_a_hand_built_trace(metric, ops, per, want):
    """(c) Known spans give the expected mean; spans outside the window (one
    request or step before it, one past its end) are left out; missing
    spans, a trace without device work, or no trace read None."""
    reader = harness.load_reader(metric)
    outside = (_serve_ops(20) + _serve_ops(995)) if metric.startswith("serve.") else (_train_ops(20) + _train_ops(990))
    assert reader.read(_ctx(ops + outside, **per)) == pytest.approx(want)
    assert reader.read(_ctx(outside, **per)) is None
    assert reader.read(_ctx([("aten::add", 200 * MS, 201 * MS)], **per)) is None
    assert reader.read(_ctx(ops, **per, device=False)) is None
    assert reader.read(SimpleNamespace(cell=None, trace=None, read={})) is None



def test_launch_tally_on_a_hand_built_trace():
    """(d) ``port_bench.launches`` gives each ``cudaLaunchKernel`` and
    ``cuLaunchKernel`` call to the phase whose span holds it (the
    backward's, from autograd's thread, to ``backward``), counts copies
    and host ops as no launch, and divides by the steps."""
    spans = [(f"bench.{p}", (100 * i + t0) * MS, (100 * i + t0 + 50) * MS)
             for t0 in (0, 1000) for i, p in enumerate(launches.PHASES)]
    host_ops = [("cudaLaunchKernel", 110 * MS, 110 * MS), ("cuLaunchKernelEx", 1120 * MS, 1120 * MS),
                ("cudaLaunchKernelExC", 1320 * MS, 1320 * MS), ("cudaLaunchKernel", 1330 * MS, 1330 * MS),
                ("cudaMemcpyAsync", 140 * MS, 140 * MS), ("aten::mm", 130 * MS, 131 * MS),
                ("cudaLaunchKernel", 470 * MS, 470 * MS)]  # between two steps: no phase
    tr = tracing.Trace(device=[("k", 0, 1)] * 6, spans=spans, host_ops=host_ops)
    got = launches.tally(tr, 2)
    assert got["launches_a_step"] == 2.5 and got["device_ops_a_step"] == 3
    assert {p: v["launches"] for p, v in got["phases"].items()} == {
        "zero_grad": 0, "forward": 1, "loss": 0, "backward": 1, "optimizer": 0}
    assert all(v["host_ms"] == 50 for v in got["phases"].values())


def test_launch_counter_runs_the_train_cell_on_the_cpu():
    """(d) The counter drives the train cell's step at its CPU widths (the
    TCN chain's plain versions) and finds every phase's span: no CUDA
    runtime here, so no launch."""
    cell = small_cell("convtasnet_lrs3.train_b12_2s")
    with kernels.plain_versions():
        got = launches.count(cell, 2**31 + 19, 2, torch.device("cpu"))
    assert got["untraced_step_ms"] > 0 and got["launches_a_step"] == 0
    assert all(v["host_ms"] > 0 and v["launches"] == 0 for v in got["phases"].values())

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k4_spans_inside_the_stacks(card):
    """A bf16 Sepformer on the card: one ``kernels.k4`` span a transformer
    layer (8 a call here), each inside its stack's span, and as many
    launches of K4's packed entry as spans."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import fused_attention_packed

    model = _sepformer().to(device=card, dtype=torch.bfloat16)
    _sepformer_call(model, card, torch.bfloat16)
    before = fused_attention_packed.launches
    spans = _profiled(_sepformer_call, model, card, torch.bfloat16)
    assert len(spans["kernels.k4"]) == 8 == fused_attention_packed.launches - before
    stacks = spans["sepformer.intra"] + spans["sepformer.inter"]
    assert len(stacks) == 4 and all(sum(_within(k, st) for st in stacks) == 1 for k in spans["kernels.k4"])


@pytest.mark.cuda
def test_traced_sepformer_cell_reads_its_metrics(card, capsys):
    """A 2 s ``--trace 1`` run of the Sepformer cell: 32 K4 launches a
    request, and ``k4_roofline`` and ``serve.transformer_issue_ms`` finite
    and above 0."""
    name = "sepformer_base.serve_b8_2s"
    assert bench_run.main(["--workload", name, "--seed", str(2**31 + 21), "--seconds", "2", "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True and got["serve.k4_launches"] == 32
    assert 0 < got["k4_roofline"] < 100 and 0 < got["serve.transformer_issue_ms"] < math.inf


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["convtasnet_lrs3.serve_b8_2s", "convtasnet_lrs3.train_b12_2s"])
def test_traced_cell_reads_the_span_metrics(card, name, capsys):
    """A 2 s ``--trace 1`` run of the cell reads each of the span metrics it
    reports (two serving, three training) as a finite number, and no span
    of the port is among the device operations."""
    assert bench_run.main(["--workload", name, "--seed", str(2**31 + 18), "--seconds", "2", "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    reported = [m["name"] for m in harness.load_cell(name).per_layer if m["name"] in METRICS]
    assert len(reported) == (3 if name.endswith("train_b12_2s") else 2) and line["correct"] is True
    assert all(math.isfinite(line["metrics"][m]["value"]) and line["metrics"][m]["value"] > 0 for m in reported)
    assert not [n for n, _ in line["breakdown"]["device_ops"] if n.startswith(PROGRAM)]





PORT = PROGRAM + ("bsrnn.", "sandglasset.")
CELLS = [w["name"] for w in harness.load_json(harness.CHECKOUT / "BENCHMARK.json")["workloads"]]
EDGE_NS = 50_000  # the ring's clock against the profiler's


def _ring_against_profile(prof):
    """The port's spans in the traced stretch, from the ring and from the
    profiler, paired by name in order of start, and the device operations'
    launch calls (paired with the operations by ``correlation_id``) that lie
    inside a port span's event.

    The ring reads the clock before the event begins and after it ends, so
    each pair's event lies inside its ring interval whatever the host does
    between the two readings, and any offset between the two clocks lies
    between minus the least end gap and the least start gap.  Returns
    {"pairs", "misordered": pairs whose ring interval does not hold the
    event, "least_start_ns", "least_end_ns": the least gaps, "edges_ns":
    [the larger of each pair's two gaps], "ops", "called": operations with
    a launch call, "launched": those whose call lies inside a port span's
    event, "outside": of those, calls outside the ring span of the innermost
    such event}.  Events are matched by time alone: the profiler numbers
    the threads of the host's operations and of the runtime's calls apart,
    and no port span is open on one thread while another launches (the
    caller waits in ``backward`` while autograd's thread runs
    ``kernels.k3``)."""
    from port_bench.span_device import is_launch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    lo, hi = next((e.start_ns(), e.end_ns()) for e in events if e.name() == tracing.WINDOW)
    marks, calls, ops = defaultdict(list), {}, []
    for e in events:
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not e.name().startswith(("bench.", "ProfilerStep")):
                ops.append(e.correlation_id())
        elif e.name().startswith(PORT) and lo <= e.start_ns() and e.end_ns() <= hi:
            marks[e.name()].append(e)
        elif is_launch(e.name()):
            calls[e.correlation_id()] = e
    rings = defaultdict(list)
    for s in profiling.recent_spans():
        if lo <= s.start_ns and s.end_ns <= hi:
            rings[s.name].append(s)
    assert sorted(rings) == sorted(marks), (sorted(rings), sorted(marks))
    pairs = []
    for name in marks:
        ev, rs = sorted(marks[name], key=lambda e: e.start_ns()), sorted(rings[name], key=lambda s: s.start_ns)
        assert len(ev) == len(rs), (name, len(ev), len(rs))
        pairs += zip(ev, rs)
    starts = [e.start_ns() - r.start_ns for e, r in pairs]
    ends = [r.end_ns - e.end_ns() for e, r in pairs]
    launched = []
    for c in ops:
        call = calls.get(c)
        holding = [(e, r) for e, r in pairs if call is not None
                   and e.start_ns() <= call.start_ns() and call.end_ns() <= e.end_ns()]
        if holding:
            launched.append((call, max(holding, key=lambda p: p[0].start_ns())[1]))
    return {"pairs": len(pairs), "misordered": sum(a < 0 or b < 0 for a, b in zip(starts, ends)),
            "least_start_ns": min(starts), "least_end_ns": min(ends),
            "edges_ns": sorted(max(abs(a), abs(b)) for a, b in zip(starts, ends)),
            "ops": len(ops), "called": sum(c in calls for c in ops), "launched": len(launched),
            "outside": sum(not r.start_ns <= c.start_ns() <= c.end_ns() <= r.end_ns for c, r in launched)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_reads_the_ring(card, name, capsys, monkeypatch):
    """A 10 s ``--trace 1`` run of the cell: every ``.unprofiled`` metric of
    the cell is in its line, finite; in the traced stretch every ring span
    holds its ``record_function`` event, which puts the two clocks within
    50 µs of each other (in fact within the least gap between a ring edge
    and its event's), and each device operation's launch call lies inside
    the ring span whose event the profiler puts it in.  Prints what it
    checked, the edges' distances (median, 99th percentile, largest, how
    many over 50 µs: the host's work and pauses between the two readings),
    and the ring's spans and period an untraced request or step."""
    profiles = []
    read = tracing.read
    monkeypatch.setattr(tracing, "read", lambda prof: (profiles.append(prof), read(prof))[1])
    assert bench_run.main(["--workload", name, "--seed", str(2**31 + 29), "--seconds", "10", "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    new = [m["name"] for m in harness.load_cell(name).per_layer if m["name"].endswith(".unprofiled")]
    got = {m: line["metrics"].get(m, {}).get("value") for m in new}
    (prof,) = profiles
    seen = _ring_against_profile(prof)
    edges = seen.pop("edges_ns")
    opens = next(e.start_ns() for e in prof.profiler.kineto_results.events() if e.name() == tracing.WINDOW)
    before = [s for s in profiling.recent_spans() if s.end_ns < opens]
    item = "serve.call" if ".serve_" in name else "train.forward"
    starts = [s.start_ns for s in before if s.name == item][-129:]
    per_item = sum(1 for s in before if starts[0] <= s.start_ns < starts[-1]) / (len(starts) - 1)
    with capsys.disabled():
        print(f"\nring against the profiler, {name}: {json.dumps(seen)}; edges median {edges[len(edges) // 2]} ns, "
              f"99th percentile {edges[len(edges) * 99 // 100]} ns, largest {edges[-1]} ns, "
              f"{sum(e > EDGE_NS for e in edges)} over {EDGE_NS} ns; {per_item:.1f} ring spans an untraced {item}, "
              f"period {(starts[-1] - starts[0]) / (len(starts) - 1) / 1e6:.3f} ms; "
              f"metrics {json.dumps(line['metrics'])}", flush=True)
    assert line["correct"] is True and new and all(v is not None and math.isfinite(v) for v in got.values()), got
    assert seen["misordered"] == 0 and seen["least_start_ns"] <= EDGE_NS and seen["least_end_ns"] <= EDGE_NS, seen
    assert seen["launched"] > 0 and seen["outside"] == 0, seen
