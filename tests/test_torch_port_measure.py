"""The port's measurement entry points on the CPU: ``utils/profiling.py``
against the JAX package's (the parameter count of all 13 configs, the
FLOPs within the tolerance measured for XLA's count), ``StepTimer`` and
``profile_trace``, and ``bench``, ``bench_train``, ``evaluated_mac_params``
and ``unit_tests`` run through their ``main`` at tiny shapes with
``--device cpu`` (their kernels' plain versions).  On the card the bench
and ``bench_train`` run in ``chip_smoke.py`` (phases 44-45).

Also the JAX scripts' measurement entry points: ``bench_all``,
``bench_batch_sweep`` and ``profile_trace_ops`` on ``--device cpu`` at
tiny shapes, ``bench_all``'s exit code when a case raises, its FLOP count
through the plain versions against ``estimate_cost`` on the f32 module,
and ``measure_gates``' verdicts on injected times (on the card: phases
49-51)."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import audio_only_speech_separation_tpu.models as jmodels
from audio_only_speech_separation_tpu.utils.profiling import count_params as jax_count_params
from audio_only_speech_separation_tpu.utils.profiling import estimate_cost as jax_estimate_cost
from audio_only_speech_separation_tpu_torch import (
    bench,
    bench_all,
    bench_batch_sweep,
    bench_train,
    evaluated_mac_params,
    measure_gates,
    models,
    profile_trace_ops,
    unit_tests,
)
from audio_only_speech_separation_tpu_torch.serve import Server
from audio_only_speech_separation_tpu_torch.utils.profiling import (
    StepTimer,
    count_params,
    estimate_cost,
    profile_trace,
)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


def test_there_are_13_configs():
    assert len(CONFIGS) == 13


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p)[:-4] for p in CONFIGS])
def test_count_params_equals_the_jax_count(path):
    """Every config's parameter count is the JAX package's (its tree from
    ``jax.eval_shape``, so nothing is computed); an LSTM's two biases count
    once, as the JAX tree's one."""
    with open(path) as f:
        config = yaml.safe_load(f)
    sr = config["datamodule"]["data_config"]["sample_rate"]
    name, cfg = config["audionet"]["audionet_name"], config["audionet"]["audionet_config"] or {}
    shapes = jax.eval_shape(jmodels.get(name)(sample_rate=sr, **cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, sr // 20), jnp.float32))
    assert count_params(models.get(name)(sample_rate=sr, **cfg, device="meta")) == jax_count_params(shapes)


def _recurrent_steps_xla_leaves_out(cfg, B, T):
    """FLOPs of the recurrent products XLA's cost analysis does not count
    for a TasNet-DPRNN at ``cfg`` on [B, T]: it counts a ``lax.scan``'s body
    once, so of each bidirectional LSTM's T steps (2 directions x 2 x
    sequences x H x 4H each) it leaves out T - 1."""
    win, K, h = cfg["win"], cfg["block_size"], cfg["hidden_dim"]
    stride = win // 2
    rest = win - (stride + T % win) % win
    frames = (T + rest + 2 * stride - win) // stride + 1
    half = K // 2
    pad = K - (half + frames % K) % K
    S = 2 * ((frames + pad + 2 * half - half) // K)
    step = 2 * 2 * h * 4 * h
    return cfg["layer"] * step * ((K - 1) * B * S + (S - 1) * B * K)


COST_CASES = {
    "ConvTasNet": ("ConvTasNet", dict(N=128, L=16, B=128, H=128, P=3, X=2, R=1, num_spks=2)),
    "ConvTasNet-narrow": ("ConvTasNet", dict(N=64, L=16, B=32, H=64, P=3, X=3, R=2, num_spks=2)),
    "TasNet-DPRNN": ("TasNet", dict(enc_dim=16, bn_dim=16, hidden_dim=32, win=16, layer=2, num_spk=2,
                                    module="DPRNN", block_size=8)),
}


@pytest.mark.parametrize("case", list(COST_CASES))
def test_estimate_cost_flops_within_the_measured_tolerance_of_xla(case):
    """``estimate_cost``'s FLOPs (the products, ``FlopCounterMode``) within
    0.85-1.0 of the JAX package's (XLA's ``cost_analysis``, which also
    counts elementwise operations: 0.86-0.96 measured).  XLA counts a scan's
    body once, so for the DPRNN the recurrent products of the T - 1 other
    steps are taken off the port's count first (0.94 measured).  The bytes
    are eager PyTorch's (every operation's inputs and outputs) and are
    checked only to cover the input and the output once."""
    name, cfg = COST_CASES[case]
    x = np.random.default_rng(0).standard_normal((2, 1200)).astype(np.float32)
    jm = jmodels.get(name)(**cfg, sample_rate=8000)
    want = jax_estimate_cost(lambda p, m: jm.apply(p, m), jm.init(jax.random.PRNGKey(0), x), x)
    model = models.get(name)(**cfg, sample_rate=8000)
    got = estimate_cost(model, torch.from_numpy(x))
    flops = got["flops"]
    if name == "TasNet":
        flops -= _recurrent_steps_xla_leaves_out(cfg, *x.shape)
    assert 0.85 <= flops / want["flops"] <= 1.0, (flops, want)
    assert got["bytes_accessed"] >= x.nbytes * (1 + 2)  # the wave in, two speakers out


def test_step_timer_and_profile_trace(tmp_path):
    timer = StepTimer(window=2)
    assert np.isnan(timer.mean) and np.isnan(timer.p50)
    for _ in range(3):
        timer.start()
        timer.stop()
    timer.stop()  # no start: nothing recorded
    assert len(timer.times) == 2 and timer.mean >= 0 and timer.p50 >= 0
    with profile_trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert any(name.endswith(".json") for name in os.listdir(tmp_path))


def test_bench_on_the_cpu_prints_the_root_benchs_line(capsys):
    """The bench at a tiny shape through K1's plain version: one JSON line
    with the root bench's keys (and ``device``)."""
    result = bench.main(["--device", "cpu", "--batch", "1", "--seconds", "0.25", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert result["metric"] == "convtasnet_lrs3_infer_throughput" and result["unit"] == "audio-sec/sec/chip"
    assert result["value"] > 0 and result["vs_baseline"] == pytest.approx(result["value"] / bench.A100_EST, abs=1e-3)
    assert result["device"] == "cpu"


def test_bench_train_runs_a_case_on_the_cpu(tmp_path, capsys):
    """One case (the fused train form's) one step at a tiny shape, and
    ``--out``; every precision mode builds its forward."""
    out = str(tmp_path / "r.json")
    results = bench_train.main(["--device", "cpu", "--only", "bf16+fusedfwd", "--batch", "1", "--seconds", "0.02",
                                "--iters", "1", "--out", out])
    assert [r["precision"] for r in results] == ["bfloat16+fused"]
    assert all("failed" not in r and np.isfinite(r["loss"]) and r["ms_per_step"] > 0 for r in results)
    model = models.ConvTasNet(**bench_train.LRS3)
    for precision in {c[5] for c in bench_train.CASES}:
        assert callable(bench_train.make_forward(model, precision))
    with open(out) as f:
        assert json.load(f) == {"device": "cpu", "cases": results}
    assert "FAILED" not in capsys.readouterr().out


def test_bench_train_reports_a_failed_case(monkeypatch, capsys):
    def broken(*args, **kwargs):
        raise RuntimeError("broken case")

    monkeypatch.setattr(bench_train, "bench_case", broken)
    results = bench_train.main(["--device", "cpu", "--only", "Sepformer"])
    assert results == [{"name": "Sepformer (base, b2x2s, bf16)", "precision": "bfloat16",
                        "failed": "RuntimeError: broken case"}]
    assert "Sepformer (base, b2x2s, bf16): FAILED (RuntimeError: broken case)" in capsys.readouterr().out


def test_evaluated_mac_params_and_unit_tests_mains_on_the_cpu():
    res = evaluated_mac_params.main(["--conf-dir", os.path.join(ROOT, "configs", "dprnn_wsj0_unfolded.yml"),
                                     "--seconds", "0.1", "--device", "cpu"])
    assert res["model"] == "TasNet" and res["params"] == 447297 and res["flops"] > 0
    res = unit_tests.main(["--model", "ConvTasNet", "--length", "800", "--batch", "1", "--epochs", "1",
                           "--device", "cpu"])
    assert res["params"] == count_params(models.ConvTasNet(sample_rate=8000)) and np.isfinite(res["loss"])


def test_the_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
    for main in (bench_train.main, unit_tests.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_bench_all_has_the_jax_scripts_cases_and_the_k2_row():
    """The 11 cases of scripts/bench_all.py at their rates and batches, in
    order, each on the path ``serve.Server`` takes on the card, the module
    rows forced to "kernels"; then "K2 alone"."""
    got = [(name.replace(" fused", ""), sr, batch, path) for name, _, sr, batch, path in bench_all.CASES]
    assert [g[:3] for g in got] == [
        ("ConvTasNet (lrs3)", 16000, 8), ("ConvTasNet (lrs3)", 16000, 8), ("TasNet-DPRNN (wsj0)", 8000, 8),
        ("TasNet-DPTNet (wsj0)", 8000, 8), ("Sepformer (base)", 16000, 2), ("TDANet (lrs2) fast-analytic", 16000, 4),
        ("TDANet (lrs2)", 16000, 4), ("AFRCNN (lrs2)", 16000, 4), ("Sandglasset (defaults)", 8000, 8),
        ("DPRNNTasNet (legacy)", 8000, 8), ("BSRNN (wsj0)", 8000, 8), ("K2 alone (ConvTasNet lrs3 TCN chain)", 16000, 8)]
    assert [g[3] for g in got] == ["fused", "kernels", "kernels", "kernels", "kernels", "fast_tdanet", "kernels",
                                   "kernels", "kernels", "kernels", "kernels", "k2"]


@pytest.mark.parametrize("only", ["TasNet-DPTNet", "lrs3) fused", "K2 alone"])
def test_bench_all_runs_a_case_and_prints_its_row(only, capsys):
    rows = bench_all.main(["--device", "cpu", "--only", only, "--batch", "1", "--seconds", "0.05", "--iters", "1"])
    out = capsys.readouterr().out
    assert len(rows) == 1 and "failed" not in rows[0]
    r = rows[0]
    assert r["ms"] > 0 and r["flops"] > 0 and r["params"] > 0 and r["audio_sec_per_s"] > 0
    assert r["gflop_per_audio_sec"] > 0 and 0 < r["peak_share"] < 1
    assert all(v == 0 for v in r["launches"].values())  # CPU tensors run the plain versions
    assert bench_all.row_line(r) in out and f"| {r['name']} [{r['path']}] |" in out and "FAILED" not in out


def test_bench_all_exits_nonzero_when_a_case_raises(monkeypatch, capsys, tmp_path):
    """A failing case prints FAILED, the sweep goes on to the next, the
    table marks it, and the process exits with 1."""
    real = bench_all.bench_one

    def broken(name, *args, **kwargs):
        if name.startswith("TasNet-DPRNN"):
            raise RuntimeError("broken case")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(bench_all, "bench_one", broken)
    with pytest.raises(SystemExit) as e:
        bench_all.main(["--device", "cpu", "--only", "TasNet-DP", "--batch", "1", "--seconds", "0.05", "--iters", "1"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "TasNet-DPRNN (wsj0): FAILED (RuntimeError: broken case)" in out
    assert "| TasNet-DPRNN (wsj0) | FAILED |" in out and "TasNet-DPTNet (wsj0) [kernels]:" in out
    with pytest.raises(SystemExit):  # a subset would overwrite a whole table
        bench_all.main(["--device", "cpu", "--only", "BSRNN", "--out", str(tmp_path / "t.md")])


def test_bench_all_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_all.main(["--only", "BSRNN"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure_gates.main([])


TINY = {
    "DPRNN": lambda: models.TasNet(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=2, num_spk=2, module="DPRNN",
                                   block_size=10, sample_rate=8000),
    "DPTNet": lambda: models.TasNet(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=2, num_spk=2,
                                    module="DPTNet", block_size=10, sample_rate=8000),
    "Sepformer": lambda: models.Sepformer(encoder_out_nchannels=16, masknet_chunksize=10, masknet_numlayers=1,
                                          intra_numlayers=1, inter_numlayers=1, intra_nhead=2, inter_nhead=2,
                                          intra_dffn=32, inter_dffn=32, sample_rate=8000),
    "BSRNN": lambda: models.BSRNN(win=64, stride=16, feature_dim=16, num_spks=2, num_repeat=1, sample_rate=8000),
}


@pytest.mark.parametrize("name", list(TINY))
def test_bench_all_flops_through_the_plain_versions_equal_the_f32_modules(name):
    """The FLOPs a row reports (its bf16 path inside ``plain_versions()``)
    within 1 % of ``estimate_cost`` on the f32 module: the kernels' plain
    versions do the products the module does."""
    torch.manual_seed(0)
    model = TINY[name]().eval()
    r = bench_all.bench_one(name, model, 8000, 2, "kernels", "cpu", iters=1, seconds=0.1)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 800)).astype(np.float32))
    want = estimate_cost(model, x)["flops"]
    assert abs(r["flops"] / want - 1) <= 0.01, (r["flops"], want)
    assert r["gflop_per_audio_sec"] == pytest.approx(r["flops"] / 0.2 / 1e9)


def test_server_takes_a_named_dispatch():
    model = TINY["DPRNN"]()
    assert Server(model, True, "cpu").dispatch == "eager"
    assert Server(model, True, "cpu", dispatch="kernels").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown dispatch"):
        Server(model, True, "cpu", dispatch="graphs")


def test_bench_batch_sweep_prints_its_rows(capsys):
    rows = bench_batch_sweep.main(["dptnet", "tdanet-module", "--device", "cpu", "--batches", "1", "2",
                                   "--seconds", "0.03", "--iters", "1"])
    assert [r["name"] for r in rows] == ["dptnet b=1", "dptnet b=2", "tdanet-module b=1", "tdanet-module b=2"]
    out = capsys.readouterr().out
    assert all(bench_all.row_line(r) in out for r in rows)
    assert set(bench_batch_sweep.SWEEPS) == {"sandglasset", "sepformer", "dptnet", "tdanet-fast", "tdanet-module"}
    assert [s[2] for s in bench_batch_sweep.SWEEPS.values()] == [(8, 16, 32), (2, 4, 8), (8, 16, 32), (4, 8, 16),
                                                                  (4, 8, 16)]


def test_profile_trace_ops_prints_the_top_operations(capsys):
    assert sorted(profile_trace_ops.CASES) == sorted(["convtasnet", "dprnn", "dptnet", "sepformer", "tdanet", "afrcnn",
                                                      "sandglasset", "dprnn_old", "bsrnn"])
    result = profile_trace_ops.main(["dprnn", "--device", "cpu", "--batch", "1", "--seconds", "0.05", "--iters", "1",
                                     "--top", "5"])
    out = capsys.readouterr().out
    assert result["dispatch"] == "eager" and result["idle"] is None and result["wall"] > 0
    assert len(result["ops"]) > 5 and all(ms >= 0 and n > 0 for _, ms, n in result["ops"])
    assert "idle share: not measured (no device)" in out
    assert sum(line.endswith(name[:110]) for line in out.splitlines() for name, _, _ in result["ops"][:5]) >= 5


def _gate_row(rule, choice, **times):
    return {"rule": rule, "name": "case", "shape": (1,), "times": times, "info": {"SDPA": 1.0}, "choice": choice}


def test_measure_gates_verdicts_on_injected_times():
    """A rule misroutes where its path is more than 10 % slower than the
    fastest; within 10 % it does not."""
    rows = [_gate_row("attention", "K4", K4=1.0, plain=2.0),
            _gate_row("attention", "K4", K4=1.09, plain=1.0),
            _gate_row("attention", "K4", K4=1.2, plain=1.0),
            _gate_row("lstm", "K6", K5=1.0, K6=1.5, plain=9.0),
            _gate_row("lstm", "K5", K5=1.0, K6=0.95, plain=9.0)]
    assert measure_gates.verdicts(rows) == 2
    assert [r["misroute"] for r in rows] == [False, False, True, True, False]
    assert [r["best"] for r in rows] == ["K4", "plain", "plain", "K5", "K6"]
    text = measure_gates.report(rows, "a card")
    assert text.count("MISROUTES") == 2 and "for information" in text


@pytest.mark.parametrize("slow_k4,code", [(1.5, 1), (1.05, None)])
def test_measure_gates_exits_1_on_a_misroute(monkeypatch, capsys, slow_k4, code):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "a card")
    monkeypatch.setattr(measure_gates, "attention_rows", lambda dev: [_gate_row("attention", "K4", K4=slow_k4,
                                                                                 plain=1.0)])
    monkeypatch.setattr(measure_gates, "lstm_rows", lambda dev: [_gate_row("lstm", "K5", K5=1.0, K6=2.0, plain=5.0)])
    if code is None:
        assert len(measure_gates.main([])) == 2
    else:
        with pytest.raises(SystemExit) as e:
            measure_gates.main([])
        assert e.value.code == code
    assert "misroute(s)" in capsys.readouterr().out


def test_measure_gates_states_the_dispatch_it_measures():
    """The rows' choices follow the port's dispatch: K4 at every head width
    the models use; ``kernel_choice``'s rule at every LSTM row (K5 only at
    BSRNN's band RNN at B=1: 501 steps of width 128 over 8 sequences), and
    on each side of each of its thresholds."""
    from audio_only_speech_separation_tpu_torch.ops import rnn

    assert all(measure_gates.attention_kernel_ok(dh) for _, dh, _ in measure_gates.ATTENTION.values())
    k5 = {name for name, shape in measure_gates.LSTM.items() if rnn.kernel_choice(*shape) == "K5"}
    assert k5 == {"bsrnn band B=1"} and len(measure_gates.LSTM) == 22
    assert {shape[4] for shape in measure_gates.LSTM.values()} == {1, 2}
    for H, D in ((64, 1), (256, 2)):
        for Din, T, B in ((rnn.WIDE_DIN, rnn.WIDE_MIN_T, rnn.WIDE_MAX_B),
                          (rnn.WIDE_DIN - 16, rnn.NARROW_MIN_T, rnn.NARROW_MAX_B)):
            assert rnn.kernel_choice(T, B, Din, H, D) == "K5"
            assert rnn.kernel_choice(T - 1, B, Din, H, D) == "K6"
            assert rnn.kernel_choice(T, B + 1, Din, H, D) == "K6"
        assert rnn.kernel_choice(rnn.WIDE_MIN_T, rnn.WIDE_MAX_B + 1, rnn.WIDE_DIN - 16, H, D) == "K6"
        assert rnn.kernel_choice(8, 1000, 40, H, D) == "K5"  # K6 takes Din % 16 == 0 only
