"""The benchmark's Sandglasset-WSJ0 configuration and the port's Sandglasset
spans.

On the CPU, at the configuration's cut for the tests
(``port_bench/tests/sizes/sandglasset_wsj0.json``: the published window,
hop, 8 heads and 6 blocks with N 16, D 64, H 16, chunks of 32 frames): the
port's ``Sandglasset`` against the plain reference
``port_bench/reference/sandglasset.py`` in float32 and, through K4's and
K6's kernel form with their plain versions, in bf16; the reference's
attention and LSTM launch shapes against those the kernel form receives;
its FLOP formula; a planted fault and the float8 control coming out as not
correct; the spans ``sandglasset.encode``, ``.local``, ``.global`` and
``.decode`` under ``torch.profiler`` and none off it; the readers of the
spans' device time (``port_bench/span_device.py``) on hand-built traces;
the cell's files as the harness finds them.  On the card (marker
``cuda``): one served 8 x 4.0 s request at the published widths launches
K4 2 times through ``fused_attention_bdt`` and 4 times through
``fused_attention_packed``, K6 6 times, no plain version, each
``kernels.k4`` / ``kernels.k6`` span inside a ``sandglasset.global`` /
``.local`` span; a traced run of the cell reads its metrics.  This file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_sandglasset_bench.py
"""

import ast
import copy
import math
import time
from collections import Counter, defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
    attention_bdt_reference,
    attention_packed_reference,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import resident_bilstm_reference
from audio_only_speech_separation_tpu_torch.serve import Server
from audio_only_speech_separation_tpu_torch.utils import profiling
from port_bench import calibrate, harness, run as bench_run, sandglasset_faults, serve_faults, span_device
from port_bench import trace as tracing
from port_bench.modes import serve
from port_bench.reference import sandglasset as ref
from port_bench.tests.small import small_cell, small_config
from port_bench.trace import Trace

CELL = "sandglasset_wsj0.serve_b8_4s"
CPU = torch.device("cpu")
SEED = 2**31 + 2**23 + 27  # past 32 signed bits, as the benchmark's seeds may be
SPANS = ("sandglasset.", "kernels.k4", "kernels.k6")
BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
PUBLISHED = harness.load_json(harness.HERE / "configs" / "sandglasset_wsj0.json")


def _model_and_sd(seed):
    cfg, _ = small_config("sandglasset_wsj0")
    sd = harness.make_state_dict(ref, cfg["model_args"], seed, CPU)
    return cfg, harness.build_model(cfg, sd, "cpu").eval(), sd


def _wave(batch, T, seed):
    return torch.randn(batch, T, generator=torch.Generator().manual_seed(seed)) * 0.05


def _rel_l2(got, want):
    return max(float((g - w).norm() / w.norm()) for g, w in zip(got, want))


def _forced_kernel_form(monkeypatch):
    """K4's two entries and K6 replaced by their plain versions (as
    ``kernels.pick`` finds them: the kernels' names), each call's shape
    recorded in order ((BH, dh, T) for K4 on either entry, (T, B, Din,
    H, D) for K6), and the card forced (``kernel_input``); returns the
    record."""
    seen = {"bdt": [], "packed": [], "K4": [], "K6": []}

    def bdt(q, k, v):
        seen["bdt"].append(tuple(q.shape))
        seen["K4"].append(tuple(q.shape))
        return attention_bdt_reference(q, k, v)

    def packed(qkv, h):
        shape = (qkv.shape[0] * h, qkv.shape[2] // 3 // h, qkv.shape[1])
        seen["packed"].append(shape)
        seen["K4"].append(shape)
        return attention_packed_reference(qkv, h)

    def resident(x, w_ih, w_hh, bias):
        seen["K6"].append((x.shape[1], x.shape[0], x.shape[2], w_hh.shape[1], w_hh.shape[0]))
        return resident_bilstm_reference(x, w_ih, w_hh, bias)

    def no_k5(*args):
        raise AssertionError("K5 launched where the reference's rule takes K6")

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_attention, "fused_attention_bdt", bdt)
    monkeypatch.setattr(port_attention, "fused_attention_packed", packed)
    monkeypatch.setattr(port_rnn, "resident_bilstm", resident)
    monkeypatch.setattr(port_rnn, "fused_bilstm", no_k5)
    return seen


def _spans(fn, *args):
    """{name: [(start ns, end ns)]} of the Sandglasset and kernel spans of
    ``fn(*args)`` under ``torch.profiler``."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        fn(*args)
    out = defaultdict(list)
    for name, s, e in tracing.read(prof).host_ops:
        if name.startswith(SPANS):
            out[name].append((s, e))
    return out


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("seed,T", [(0, 800), (7, 1203), (11, 3)])
def test_reference_is_the_port_in_float32(seed, T):
    """The port's f32 module and the plain reference, written apart
    (channels first, ``F.unfold`` / ``F.fold``, ``F.avg_pool1d``,
    ``F.interpolate``, the LSTM's step equations): within 1e-5 of the
    answers' largest magnitude (they read 1e-7 to 5e-7 apart)."""
    cfg, model, sd = _model_and_sd(seed)
    x = _wave(2, T, seed)
    with torch.no_grad():
        want, got = model(x), ref.forward(sd, x, cfg["model_args"])
    assert got.shape == want.shape == (2, 2, T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("seed", [0, 7])
def test_kernel_form_in_bf16_is_the_reference(monkeypatch, seed):
    """The served form: the module cast to bf16 as ``Server`` casts it, the
    card forced so that every attention takes K4's kernel form (the
    [B*h, dh, T] entry at the blocks that pool by 1, the packed entry at
    the others) and every LSTM K6's, their plain versions run.  Tolerance
    0.035 relative l2 a source: on 6 seeds the answers read 1.15-2.05 %
    (bf16 keeps 8 significant bits through 6 blocks of residual gLN,
    LayerNorm and the LSTM's state), the float8 control 10.2-19.5 %, 2.9
    times the tolerance and more."""
    seen = _forced_kernel_form(monkeypatch)
    cfg, model, sd = _model_and_sd(seed)
    x = _wave(2, 800, seed)
    with torch.no_grad():
        got = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16)).float()
    want = ref.forward(sd, x, cfg["model_args"])
    assert (len(seen["bdt"]), len(seen["packed"]), len(seen["K6"])) == (2, 4, 6)
    assert _rel_l2(got, want) <= 0.035


@pytest.mark.parametrize("batch,T", [(2, 800), (1, 2001)])
def test_launch_shapes_are_what_the_kernel_form_receives(monkeypatch, batch, T):
    """``attention_shapes`` and ``lstm_shapes`` give, in order, the shapes
    K4's two entries and K6 receive in a forward with the dispatch forced
    as the card takes it (the readers' rooflines count these)."""
    seen = _forced_kernel_form(monkeypatch)
    cfg, model, _ = _model_and_sd(0)
    a = cfg["model_args"]
    with torch.no_grad():
        copy.deepcopy(model).to(torch.bfloat16)(_wave(batch, T, 1).to(torch.bfloat16))
    assert seen["K4"] == ref.attention_shapes(a, batch, T)
    assert seen["bdt"] == [ref.attention_shapes(a, batch, T)[i] for i in (0, 5)]
    assert seen["K6"] == ref.lstm_shapes(a, batch, T)["K6"] and ref.lstm_shapes(a, batch, T)["K5"] == []


@pytest.mark.parametrize("T", [800, 2001])
def test_flop_formula_is_flopcountermodes(T):
    """The formula of one wave, times the batch of 2, counts exactly the
    products FlopCounterMode counts in the reference's forward (no norm,
    pooling, interpolation, softmax or elementwise FLOPs in either)."""
    cfg, _ = small_config("sandglasset_wsj0")
    a = cfg["model_args"]
    sd = harness.make_state_dict(ref, a, 5, CPU)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(sd, _wave(2, T, 1), a)
    assert counter.get_total_flops() == 2 * ref.forward_flops(a, T)


def test_forward_flops_grow_with_the_length():
    a = PUBLISHED["model_args"]
    flops = [ref.forward_flops(a, T) for T in (8000, 16000, 32000, 64000)]
    assert flops[0] > 0 and all(x < y for x, y in zip(flops, flops[1:]))


def test_published_request_by_hand():
    """One 8 x 4.0 s request at 8 kHz: 32,002 frames and 259 chunks of 250 a
    clip; K4 at [16000, 16, 259] in blocks 0 and 5 (8 x 250 rows x 8 heads)
    and at [3968, 16, 259] and [960, 16, 259] twice each (K pooled to 62
    and 15 rows); K6 six times at (250, 2072, 128, 128, 2); 2,210,433
    parameters; 276.5 GFLOP a clip, 229.4 of them the local BiLSTMs."""
    a = PUBLISHED["model_args"]
    assert ref.frames(a, 32000) == 32002 and ref.chunks(a, 32002) == 259
    assert ref.attention_shapes(a, 8, 32000) == [(16000, 16, 259), (3968, 16, 259), (960, 16, 259),
                                                 (960, 16, 259), (3968, 16, 259), (16000, 16, 259)]
    assert ref.lstm_shapes(a, 8, 32000) == {"K5": [], "K6": [(250, 2072, 128, 128, 2)] * 6}
    assert sum(math.prod(s) for _, s, _, _ in ref.param_shapes(a)) == 2_210_433
    local = 6 * 259 * 250 * (2 * 2 * 128 * 512 + 2 * 2 * 128 * 512 + 2 * 256 * 128)
    assert local == pytest.approx(229.2e9, rel=1e-3)
    assert ref.forward_flops(a, 32000) == pytest.approx(276.5e9, rel=1e-3)


def test_planted_fault_and_control_are_not_correct():
    """At the cut, a run with the last block's mirrored skip lost exceeds
    the cell's limit and comes out as not correct, and so does the float8
    control; a sound run is correct."""
    cell = small_cell(CELL)
    sound = serve.run(cell, SEED, 0.3, False, CPU, time.perf_counter())
    assert bench_run.result_line(cell, sound, False, BENCH)["correct"] is True, sound.checks
    with serve_faults.planted(sandglasset_faults.FAULTS["fault_last_block_skip_lost"]):
        run = serve.run(cell, SEED, 0.3, False, CPU, time.perf_counter())
    assert run.checks["serve_rel_err"] > cell.limits["serve_rel_err"], run.checks
    assert bench_run.result_line(cell, run, False, BENCH)["correct"] is False
    assert calibrate.control_serve(cell, SEED, CPU)["serve_rel_err"] > cell.limits["serve_rel_err"]


def test_spans_off_the_profiler(monkeypatch):
    """Off the profiler a forward never enters ``record_function``, and the
    port's span ring gains its spans and nothing else: one
    ``sandglasset.encode``, per block one ``sandglasset.local`` and one
    ``sandglasset.global``, one ``sandglasset.decode`` (no attention or LSTM
    takes a kernel on the CPU)."""
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, model, _ = _model_and_sd(0)
    before = max((s.slot for s in profiling.recent_spans()), default=-1)
    with torch.no_grad():
        assert torch.isfinite(model(_wave(1, 800, 0))).all()
    gained = Counter(s.name for s in profiling.recent_spans() if s.slot > before)
    assert gained == Counter({"sandglasset.encode": 1, "sandglasset.local": 6, "sandglasset.global": 6,
                              "sandglasset.decode": 1})


def test_spans_under_the_profiler():
    """Under the profiler a forward gives one ``sandglasset.encode``, then
    per block one ``sandglasset.local`` and one ``sandglasset.global``,
    then one ``sandglasset.decode``, in that order and apart; on the CPU no
    attention or LSTM takes a kernel, so no ``kernels.k4`` or
    ``kernels.k6``."""
    _, model, _ = _model_and_sd(0)
    with torch.no_grad():
        spans = _spans(model, _wave(1, 800, 0))
    assert sorted(spans) == ["sandglasset.decode", "sandglasset.encode", "sandglasset.global",
                             "sandglasset.local"], dict(spans)
    order = sorted((s, n) for n, v in spans.items() for s in v)
    assert [n for _, n in order] == (["sandglasset.encode"] + ["sandglasset.local", "sandglasset.global"] * 6
                                     + ["sandglasset.decode"])
    assert all(a[0][1] <= b[0][0] for a, b in zip(order, order[1:]))


def _trace(requests, ops, spans, launches=None):
    """A hand-built trace: ``requests`` [(start, end)] as ``bench.request``
    spans, ``ops`` [(start, end)] on the device, each launched 1 ns after
    ``launches``' entry (by default 5 ns before it starts), ``spans``
    [(name, start, end)] of the port."""
    launches = [s - 5 for s, _ in ops] if launches is None else launches
    host = [("cudaLaunchKernel", c, c + 1) for c in launches] + list(spans)
    return Trace(device=[("k", s, e) for s, e in ops], spans=[("bench.request", s, e) for s, e in requests],
                 host_ops=host, window=(0, 10**6))


def _ctx(trace, n):
    return SimpleNamespace(trace=trace, read={"traced": {"requests": [[32000] * 8] * n}})


def test_span_device_time_pairs_launches_in_order():
    """Each device operation is charged to the span its launch lies in, by
    issue order inside each request, over the traced requests: the
    operations run later than their launches, so only the pairing puts
    them in their spans."""
    ops = [(100, 130), (140, 200), (210, 220), (1100, 1150), (1160, 1170)]
    launches = [10, 20, 30, 1010, 1020]
    spans = [("sandglasset.local", 5, 15), ("sandglasset.global", 16, 25), ("sandglasset.local", 1005, 1015)]
    tr = _trace([(0, 300), (1000, 1300)], ops, spans, launches)
    assert span_device.span_device_ms(_ctx(tr, 2), "sandglasset.local") == pytest.approx((30 + 50) / 1e6 / 2)
    assert span_device.span_device_ms(_ctx(tr, 2), "sandglasset.global") == pytest.approx(60 / 1e6 / 2)


def test_span_device_time_is_none_where_nothing_pairs():
    """None where a request's launches and operations differ in number,
    where the program has no such span (the parent's program), and without
    a card trace."""
    spans = [("sandglasset.local", 0, 50)]
    unpaired = _trace([(0, 300)], [(100, 130), (140, 200)], spans, [10])
    assert span_device.span_device_ms(_ctx(unpaired, 1), "sandglasset.local") is None
    no_span = _trace([(0, 300)], [(100, 130)], [])
    assert span_device.span_device_ms(_ctx(no_span, 1), "sandglasset.local") is None
    assert span_device.span_device_ms(_ctx(None, 1), "sandglasset.local") is None
    assert span_device.is_launch("cuLaunchKernelEx") and span_device.is_launch("cudaMemsetAsync")
    assert not span_device.is_launch("cudaStreamSynchronize")


@pytest.mark.parametrize("metric", ["serve.sandglass_local_ms", "serve.sandglass_global_ms"])
def test_span_readers_read_their_span(metric):
    side = metric.split("_")[1]
    tr = _trace([(0, 300)], [(100, 130), (140, 200)], [(f"sandglasset.{side}", 0, 12)], [10, 20])
    assert harness.load_reader(metric).read(_ctx(tr, 1)) == pytest.approx(30 / 1e6)


def test_cell_files_as_the_harness_finds_them():
    """The cell, its configuration, traffic and limit by name; every
    per-layer metric it reports has a reader and moves a metric it reports;
    the configuration names look2hear's class and cuts nothing; the
    reference's parameters are the port's model's at the published widths
    and the benchmark's weights load into it."""
    cell = harness.load_cell(CELL, BENCH)
    assert cell.cfg is not None and set(cell.limits) == {"serve_rel_err"} and cell.chips == 1
    assert set(cell.end_to_end) == {"serve_audio_s_per_s", "serve_p95_ms", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"k4_roofline", "k6_roofline", "mfu.serve", "serve.k4_launches", "serve.lstm_launches",
            "serve.sandglass_local_ms", "serve.sandglass_global_ms"} <= names
    for m in cell.per_layer:
        assert m["moves"] in cell.end_to_end and callable(harness.load_reader(m["name"]).read)
    entry = next(c for c in BENCH["configs"] if c["name"] == "sandglasset_wsj0")
    assert PUBLISHED["source"] == entry["source"] and PUBLISHED["reduced"] == entry["reduced"] == []
    assert cell.traffic["batch"] == 8 and cell.traffic["lengths"] == {"fixed_s": 4.0}
    sd = harness.make_state_dict(ref, PUBLISHED["model_args"], SEED, CPU)
    model = harness.build_model(PUBLISHED, sd, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in sd.items()}


def test_reference_imports_nothing_of_the_port_or_jax():
    path = Path(harness.HERE) / "reference" / "sandglasset.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
        assert not any(n.split(".")[0] in harness.FORBIDDEN + ("audio_only_speech_separation_tpu_torch",)
                       for n in names), names


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 and K6 run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_served_request_spans_and_launches(card, monkeypatch):
    """One 8 x 4.0 s request served at the published widths through
    ``Server``'s "kernels" dispatch under ``torch.profiler``: K4's counters
    add 2 on the [B*h, dh, T] entry and 4 on the packed one, K6's 6, no
    plain version is called; one ``sandglasset.encode`` and one
    ``.decode``, 6 ``.local`` each holding one ``kernels.k6``, 6
    ``.global`` each holding one ``kernels.k4``."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        fused_attention_bdt,
        fused_attention_packed,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import resident_bilstm

    def refuse(*args):
        raise AssertionError("a plain version ran on the card")

    for module, name in ((port_attention, "attention_bdt_reference"), (port_attention, "attention_packed_reference"),
                         (port_rnn, "bilstm_reference"), (port_rnn, "resident_bilstm_reference")):
        monkeypatch.setattr(module, name, refuse)
    sd = harness.make_state_dict(ref, PUBLISHED["model_args"], SEED, card)
    server = Server(harness.build_model(PUBLISHED, sd, card), use_bf16=True, device=card, bucket_seconds=1.0)
    assert server.dispatch == "kernels"
    req = [np.random.default_rng(i).standard_normal(32000).astype(np.float32) * 0.05 for i in range(8)]
    server(req)
    bdt, packed, k6 = fused_attention_bdt.launches, fused_attention_packed.launches, resident_bilstm.launches
    spans = _spans(server, req)
    assert (fused_attention_bdt.launches - bdt, fused_attention_packed.launches - packed,
            resident_bilstm.launches - k6) == (2, 4, 6)
    assert len(spans["sandglasset.encode"]) == len(spans["sandglasset.decode"]) == 1
    for stage, kernel in (("sandglasset.local", "kernels.k6"), ("sandglasset.global", "kernels.k4")):
        assert len(spans[stage]) == len(spans[kernel]) == 6
        assert all(sum(_within(k, st) for st in spans[stage]) == 1 for k in spans[kernel])


@pytest.mark.cuda
def test_traced_sandglasset_cell_reads_its_metrics(card):
    """A 2 s ``--trace 1`` run of the cell: 6 K4 and 6 K6 launches a
    request, both rooflines above 0 and under 100 %, both span readers a
    number, together at least 70 % of a traced request's device time, and
    the run correct."""
    cell = harness.load_cell(CELL, BENCH)
    run = serve.run(cell, SEED, 2.0, True, card, time.perf_counter())
    line = bench_run.result_line(cell, run, True, BENCH)
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True and got["serve.k4_launches"] == 6 and got["serve.lstm_launches"] == 6
    assert 0 < got["k4_roofline"] < 100 and 0 < got["k6_roofline"] < 100
    assert math.isfinite(got["mfu.serve"]) and got["mfu.serve"] > 0
    device_ms = sum(e - s for _, s, e in run.trace.device) / 1e6 / len(run.read["traced"]["requests"])
    spans_ms = got["serve.sandglass_local_ms"] + got["serve.sandglass_global_ms"]
    assert got["serve.sandglass_local_ms"] > 0 and got["serve.sandglass_global_ms"] > 0
    assert 0.7 * device_ms <= spans_ms <= device_ms, (spans_ms, device_ms)
