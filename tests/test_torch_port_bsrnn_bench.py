"""The benchmark's BSRNN-WSJ0 configuration and the port's BSRNN spans.

On the CPU, at the configuration's cut for the tests
(``port_bench/tests/sizes/bsrnn_wsj0.json``: N 16, 2 BSNets, the published
window, hop and 8 kHz, so the 8 published bands): the port's ``BSRNN``
against the plain reference ``port_bench/reference/bsrnn.py`` through K5's
and K6's kernel form with the plain versions, in bf16; a planted fault
coming out as not correct; the spans ``bsrnn.split``, ``bsrnn.band_rnn``,
``bsrnn.band_comm`` and ``bsrnn.mask`` under ``torch.profiler`` and none
off it.  On the card (marker ``cuda``): one served 6.0 s request at the
published widths gives 8 ``kernels.k5`` and 8 ``kernels.k6`` spans, each
inside its RNN stage's span, and the launch counters add 8 and 8; a traced
run of the cell reads its three kernel metrics.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_bsrnn_bench.py
"""

import copy
import json
import math
import time
from collections import defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import bilstm_reference, resident_bilstm_reference
from audio_only_speech_separation_tpu_torch.serve import Server
from audio_only_speech_separation_tpu_torch.utils import profiling
from port_bench import bsrnn_faults, harness, run as bench_run, serve_faults
from port_bench import trace as tracing
from port_bench.modes import serve
from port_bench.reference import bsrnn as ref
from port_bench.tests.small import small_cell, small_config

CELL = "bsrnn_wsj0.serve_b1_wsj0len"
CPU = torch.device("cpu")
SEED = 2**31 + 2**23 + 25  # past 32 signed bits, as the benchmark's seeds may be
SPANS = ("bsrnn.", "kernels.k5", "kernels.k6")


def _model_and_sd(seed):
    cfg, _ = small_config("bsrnn_wsj0")
    sd = harness.make_state_dict(ref, cfg["model_args"], seed, CPU)
    return cfg, harness.build_model(cfg, sd, "cpu").eval(), sd


def _wave(batch, T, seed):
    return torch.randn(batch, T, generator=torch.Generator().manual_seed(seed)) * 0.05


def _rel_l2(got, want):
    return max(float((g - w).norm() / w.norm()) for g, w in zip(got, want))


def _spans(fn, *args):
    """{name: [(start ns, end ns)]} of the BSRNN and LSTM-kernel spans of
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


@pytest.mark.parametrize("seed", [0, 7])
def test_kernel_form_in_bf16_is_the_reference(monkeypatch, seed):
    """The served form: the module cast to bf16 as ``Server`` casts it, the
    card forced (``kernel_input``) so that every LSTM takes K5's or K6's
    kernel form, their plain versions counted (2 each at the cut's 2
    BSNets on 1.25 s: K5 over 157 frames of 8 bands, K6 across the bands).
    Tolerance 0.015 relative l2 a source: on 6 seeds the answers read
    0.57-0.60 % (bf16 keeps 8 significant bits through the bottleneck, 4
    residual RNNs and the mask heads), the float8 control 4.1-4.6 %, over
    2.7 times the tolerance."""
    calls = {"K5": 0, "K6": 0}

    def counted(label, plain):
        def run(*args):
            calls[label] += 1
            return plain(*args)
        return run

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_rnn, "bilstm_reference", counted("K5", bilstm_reference))
    monkeypatch.setattr(port_rnn, "resident_bilstm_reference", counted("K6", resident_bilstm_reference))
    cfg, model, sd = _model_and_sd(seed)
    x = _wave(2, 10000, seed)
    with torch.no_grad(), kernels.plain_versions():
        got = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16)).float()
    want = ref.forward(sd, x, cfg["model_args"])
    assert calls == {"K5": 2, "K6": 2}
    assert _rel_l2(got, want) <= 0.015


def test_planted_fault_is_not_correct():
    """At the cut, a run with the widest band's mask-head PReLU slope lost
    exceeds the cell's limit and comes out as not correct (the float8
    control is ``test_port_bench_reference.py::test_control_is_not_correct``'s
    case of this cell)."""
    cell = small_cell(CELL)
    with serve_faults.planted(bsrnn_faults.FAULTS["fault_widest_band_prelu_lost"]):
        run = serve.run(cell, SEED, 0.3, False, CPU, time.perf_counter())
    bench = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")
    assert run.checks["serve_rel_err"] > cell.limits["serve_rel_err"], run.checks
    assert bench_run.result_line(cell, run, False, bench)["correct"] is False


def test_spans_off_the_profiler(monkeypatch):
    """Off the profiler a BSRNN forward makes no span object: each
    ``bsrnn.*`` span is the one shared no-op, and ``record_function`` is
    never entered."""
    assert profiling.span("bsrnn.split") is profiling.span("kernels.k5")

    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, model, _ = _model_and_sd(0)
    with torch.no_grad():
        assert torch.isfinite(model(_wave(1, 4000, 0))).all()


def test_spans_under_the_profiler():
    """Under the profiler a forward gives one ``bsrnn.split``, then per
    BSNet one ``bsrnn.band_rnn`` and one ``bsrnn.band_comm``, then one
    ``bsrnn.mask``, in that order and apart; on the CPU no LSTM takes a
    kernel, so no ``kernels.k5`` or ``kernels.k6``."""
    _, model, _ = _model_and_sd(0)
    with torch.no_grad():
        spans = _spans(model, _wave(1, 4000, 0))
    assert sorted(spans) == ["bsrnn.band_comm", "bsrnn.band_rnn", "bsrnn.mask", "bsrnn.split"], dict(spans)
    assert len(spans["bsrnn.split"]) == len(spans["bsrnn.mask"]) == 1
    assert len(spans["bsrnn.band_rnn"]) == len(spans["bsrnn.band_comm"]) == 2
    order = sorted((s, n) for n, v in spans.items() for s in v)
    assert [n for _, n in order] == ["bsrnn.split"] + ["bsrnn.band_rnn", "bsrnn.band_comm"] * 2 + ["bsrnn.mask"]
    assert all(a[0][1] <= b[0][0] for a, b in zip(order, order[1:]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 and K6 run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_served_request_spans_and_launches(card):
    """One 6.0 s request served at the published widths through ``Server``'s
    "kernels" dispatch under ``torch.profiler``: one ``bsrnn.split`` and one
    ``bsrnn.mask``, 8 ``bsrnn.band_rnn`` each holding one ``kernels.k5``, 8
    ``bsrnn.band_comm`` each holding one ``kernels.k6``; K5's and K6's
    launch counters add 8 and 8, all 8 of K5's in its few-sequence body."""
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import fused_bilstm, resident_bilstm

    cfg = harness.load_json(harness.HERE / "configs" / "bsrnn_wsj0.json")
    sd = harness.make_state_dict(ref, cfg["model_args"], SEED, card)
    server = Server(harness.build_model(cfg, sd, card), use_bf16=True, device=card, bucket_seconds=1.0)
    req = [np.random.default_rng(0).standard_normal(48000).astype(np.float32) * 0.05]
    server(req)
    k5, k6, k5_small = fused_bilstm.launches, resident_bilstm.launches, fused_bilstm.small_batch_launches
    spans = _spans(server, req)
    assert fused_bilstm.launches - k5 == 8 and resident_bilstm.launches - k6 == 8
    assert fused_bilstm.small_batch_launches - k5_small == 8
    assert len(spans["bsrnn.split"]) == len(spans["bsrnn.mask"]) == 1
    for stage, kernel in (("bsrnn.band_rnn", "kernels.k5"), ("bsrnn.band_comm", "kernels.k6")):
        assert len(spans[stage]) == len(spans[kernel]) == 8
        assert all(sum(_within(k, st) for st in spans[stage]) == 1 for k in spans[kernel])


@pytest.mark.cuda
def test_traced_bsrnn_cell_reads_its_metrics(card, capsys):
    """A 2 s ``--trace 1`` run of the cell: 16 K5 and K6 launches a request,
    both rooflines above 0 and under 100 %, and the run correct."""
    assert bench_run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "2", "--trace", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert line["correct"] is True and got["serve.lstm_launches"] == 16
    assert 0 < got["k5_roofline"] < 100 and 0 < got["k6_roofline"] < 100
    assert math.isfinite(got["mfu.serve"]) and got["mfu.serve"] > 0
