"""The benchmark's Sepformer-LRS2 configuration on the CPU, at its cut for
the tests (``port_bench/tests/sizes/sepformer_base.json``: N 32, 4 heads,
2 + 2 layers a stack, 2 dual blocks, chunks of 20, FFN 64): the port's
``Sepformer`` against the plain reference ``port_bench/reference/sepformer.py``
in float32 and, through K4's kernel form with the plain versions, in bf16;
the reference's imports; its FLOP formula against ``FlopCounterMode``; K4's work
function and the attention shapes at the published widths; and the float8
control and a planted fault coming out as not correct."""

import copy
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import attention_packed_reference
from port_bench import calibrate, harness, run as bench_run, serve_faults
from port_bench.attention_work import attention_work
from port_bench.modes import serve
from port_bench.reference import sepformer as ref
from port_bench.tests.small import small_cell, small_config

CELL = "sepformer_base.serve_b8_2s"
CPU = torch.device("cpu")
SEED = 2**31 + 2**21 + 5  # past 32 signed bits, as the benchmark's seeds may be


def _model_and_sd(seed):
    cfg, _ = small_config("sepformer_base")
    sd = harness.make_state_dict(ref, cfg["model_args"], seed, CPU)
    return cfg, harness.build_model(cfg, sd, "cpu").eval(), sd


def _wave(batch, T, seed):
    return torch.randn(batch, T, generator=torch.Generator().manual_seed(seed)) * 0.05


def _rel_l2(got, want):
    return max(float((g - w).norm() / w.norm()) for g, w in zip(got, want))


def test_reference_loads_nothing_of_the_port_or_jax():
    """Imported alone, the reference loads neither the port nor JAX nor the
    JAX package (``port_bench/tests/test_port_bench_reference.py`` reads
    every reference's imports; this runs the new one's)."""
    code = "import sys, port_bench.reference.sepformer; print(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=harness.CHECKOUT).stdout
    for bad in ("jax", "jaxlib", "flax", "audio_only_speech_separation_tpu", "audio_only_speech_separation_tpu_torch"):
        assert f"'{bad}'" not in out


@pytest.mark.parametrize("T", [4001, 3333, 8000], ids=["pad_1", "pad_5", "exact"])
def test_port_is_the_reference_in_float32(T):
    """The port's module and the reference on the same seeded weights agree
    to float32 rounding (1e-5 of the output's scale) at lengths whose
    decoder output falls short of the input (padded back) or meets it; the
    decoder never gives more than T samples, so the crop branch is the
    reference's alone."""
    cfg, model, sd = _model_and_sd(3)
    x = _wave(2, T, 1)
    with torch.no_grad():
        want, got = model(x), ref.forward(sd, x, cfg["model_args"])
    assert got.shape == want.shape == (2, 2, T)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("seed", [0, 7])
def test_kernel_form_in_bf16_is_the_reference(monkeypatch, seed):
    """The served form: the module cast to bf16 as ``Server`` casts it,
    the card forced (``kernel_input``) so that every attention takes K4's
    kernel form, and ``plain_versions()`` gives it the plain version of K4's
    packed entry (counted, as [B*h, dh, T]: 8 a call at the cut).
    Tolerance 0.025 relative l2 a source: bf16 keeps 8 significant bits,
    about 0.2 % a rounding, and over the cut's 8 layers, 6 gLNs and the
    gate the answers read 1.1-1.3 % on 6 seeds; the float8 control reads
    10-12 %, four times the tolerance and more."""
    calls = []

    def counted(qkv, num_heads):
        calls.append((qkv.shape[0] * num_heads, qkv.shape[2] // (3 * num_heads), qkv.shape[1]))
        return attention_packed_reference(qkv, num_heads)

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_attention, "attention_packed_reference", counted)
    cfg, model, sd = _model_and_sd(seed)
    x = _wave(2, 8000, seed)
    with torch.no_grad(), kernels.plain_versions():
        got = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16)).float()
    want = ref.forward(sd, x, cfg["model_args"])
    assert len(calls) == 8 and all(c[1] == 8 for c in calls)
    assert _rel_l2(got, want) <= 0.025


@pytest.mark.parametrize("T", [4001, 32000])
def test_flop_formula_is_flopcountermodes(T):
    """The formula counts exactly the products FlopCounterMode counts in
    the reference's forward (no norm, softmax or elementwise FLOPs in
    either)."""
    cfg, _, sd = _model_and_sd(1)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(sd, _wave(1, T, 2), cfg["model_args"])
    assert counter.get_total_flops() == ref.forward_flops(cfg["model_args"], T)


@pytest.mark.parametrize("BH,dh,T", [(2176, 32, 250), (16000, 32, 34)], ids=["intra", "inter"])
def test_k4_work_by_hand(BH, dh, T):
    """q, k, v and o once in bf16, and per head T x T logits of dh
    multiply-adds and T x dh weighted sums of T, 2 FLOPs each."""
    nbytes, flops = attention_work(BH, dh, T)
    assert nbytes == BH * (3 + 1) * (dh * T) * 2
    assert flops == BH * (T * T * dh + dh * T * T) * 2


def test_attention_shapes_at_the_published_widths():
    """8 clips of 2.0 s at 16 kHz: 3999 frames, 34 chunks of 250; 32
    attentions a call, 16 intra [8 x 34 x 8, 32, 250] and 16 inter
    [8 x 250 x 8, 32, 34], block by block."""
    cfg = harness.load_json(harness.HERE / "configs" / "sepformer_base.json")["model_args"]
    assert ref.frames(cfg, 32000) == 3999 and ref.chunks(cfg, 3999) == 34
    shapes = ref.attention_shapes(cfg, 8, 32000)
    assert shapes == ([(2176, 32, 250)] * 8 + [(16000, 32, 34)] * 8) * 2


@pytest.mark.parametrize("kind", ["control", "fault_inter_positions_left_out"])
def test_control_and_fault_are_not_correct(kind):
    """At the cut, the float8 control (the reference's products in float8
    e4m3, one precision below bf16) and a run with the first inter stack's
    positions left out both exceed the cell's limit."""
    cell = small_cell(CELL)
    if kind == "control":
        checks = calibrate.control_serve(cell, SEED, CPU)
    else:
        with serve_faults.planted(serve_faults.FAULTS["sepformer"][kind]):
            checks = serve.run(cell, SEED, 0.3, False, CPU, time.perf_counter()).checks
    assert checks["serve_rel_err"] > cell.limits["serve_rel_err"], checks


def test_cell_runs_end_to_end_and_is_correct():
    """The cell at its cut, through the serving mode and the result line:
    every answer checked against the reference and within the limit."""
    cell = small_cell(CELL)
    run = serve.run(cell, SEED, 0.3, False, CPU, time.perf_counter())
    line = bench_run.result_line(cell, run, False, harness.load_json(harness.CHECKOUT / "BENCHMARK.json"))
    assert line["correct"] is True and run.failed == 0 and run.attempted > 0
    assert set(line["metrics"]) == {"serve_audio_s_per_s", "serve_p95_ms", "setup_s"}
