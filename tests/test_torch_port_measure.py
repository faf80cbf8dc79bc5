"""The port's measurement entry points on the CPU: ``utils/profiling.py``
against the JAX package's (the parameter count of all 13 configs, the
FLOPs within the tolerance measured for XLA's count), ``StepTimer`` and
``profile_trace``, and ``bench``, ``bench_train``, ``evaluated_mac_params``
and ``unit_tests`` run through their ``main`` at tiny shapes with
``--device cpu`` (their kernels' plain versions).  On the card the bench
and ``bench_train`` run in ``chip_smoke.py`` (phases 44-45)."""

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
from audio_only_speech_separation_tpu_torch import bench, bench_train, evaluated_mac_params, models, unit_tests
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
