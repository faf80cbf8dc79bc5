"""The port's training-quality study (``validate.py``, counterpart of the
JAX package's ``scripts/validate_pallas.py::kernel_train_quality`` and
``::bf16_quality_study``) at a tiny size on the CPU, where the TCN chain's
kernels and the whole-separator kernel run as their plain versions.  The
full-width study runs on the card through ``validate.py``'s command line."""

import ast
import os

import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu_torch import validate
from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_backward

torch.set_num_threads(2)
_SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "validate_pallas.py")
TINY = dict(validate.CONVTASNET, N=128, H=128, X=2, R=1)


def _script_si_sdr():
    """The script's ``_si_sdr``, compiled from its source alone (importing
    the script would run its JAX-package imports and module set-up)."""
    tree = ast.parse(open(_SCRIPT).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_si_sdr")
    namespace = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), _SCRIPT, "exec"), namespace)
    return namespace["_si_sdr"]


def test_si_sdr_is_the_scripts():
    """The port's SI-SDR against the script's on random and on close
    estimates: equal to the last bit (the same numpy operations)."""
    script = _script_si_sdr()
    rng = np.random.default_rng(0)
    for noise in (3.0, 0.1):
        ref = rng.standard_normal(1600)
        est = ref + noise * rng.standard_normal(1600)
        assert validate.si_sdr(est, ref) == script(est, ref)


def test_study_data_is_the_scripts_task():
    """Four mixtures of two sources, a chirped sine and noise at 0.3 from
    numpy's generator seeded 3, summed."""
    mix, srcs = validate.study_data()
    assert mix.shape == (4, 16000) and srcs.shape == (4, 2, 16000) and mix.dtype == np.float32
    np.testing.assert_array_equal(mix, srcs.sum(1))
    noise = (np.random.default_rng(3).normal(size=16000) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(srcs[0, 1], noise)
    assert abs(float(srcs[1, 0].max()) - 1.0) < 1e-3


def test_tiny_study_through_the_plain_versions(monkeypatch):
    """Three steps an arm at a tiny width from two seeds: finite SI-SDRi
    (after the last step and over the last two steps' models), losses and
    times, the f32 arm at the first seed only, the training gate on the
    mean of the seeds' differences of tail averages (the script's reading
    at the first seed reported beside it), and the kernel arm's forward
    through the TCN chain (its plain versions on the CPU) at each seed."""
    chain_calls = []
    real = convtasnet_backward.fused_tcn_separator

    def counting(*args, **kwargs):
        chain_calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(convtasnet_backward, "fused_tcn_separator", counting)
    r = validate.kernel_train_quality(steps=3, device="cpu", cfg=TINY, samples=800, seeds=(0, 1), tail=2)
    first, second = r["per_seed"]
    assert (first["seed"], second["seed"]) == (0, 1) and "f32" in first and "f32" not in second
    for arm in validate.ARMS:
        assert np.isfinite([r[arm], r[f"{arm}_tail"], r[f"{arm}_final_loss_db"]]).all()
        assert r[f"{arm}_seconds"] > 0
    assert r["bf16_kernel_tail"] == np.mean([first["bf16_kernel_tail"], second["bf16_kernel_tail"]])
    assert r["script_reading_delta_db"] == first["bf16_plain"] - first["bf16_kernel"]
    deltas = [row["bf16_plain_tail"] - row["bf16_kernel_tail"] for row in (first, second)]
    gate = validate.train_gate(deltas)
    assert {k: r[k] for k in gate} == gate
    assert all(isinstance(r[k], bool) for k in ("train_gate_ok", "serve_gate_ok"))
    assert r["ok"] == (r["train_gate_ok"] and r["serve_gate_ok"])
    assert len(chain_calls) == 2 * 3


def test_train_gate_reads_the_mean_over_seeds():
    """The gate takes the mean of the seeds' differences, not any one of
    them, and reports its standard error (sample deviation over the root of
    the count; 0 for one seed); |mean| < 0.3 dB passes."""
    gate = validate.train_gate([0.5, -0.4, 0.1, -0.2])
    assert gate["train_gate_ok"] and abs(gate["train_gate_delta_db"]) < 1e-12
    assert abs(gate["train_gate_se_db"] - float(np.std([0.5, -0.4, 0.1, -0.2], ddof=1)) / 2) < 1e-12
    assert not validate.train_gate([0.35, 0.3, 0.4])["train_gate_ok"]
    assert validate.train_gate([-0.29]) == {"train_gate_delta_db": -0.29, "train_gate_se_db": 0.0,
                                            "train_gate_ok": True}
    with pytest.raises(ValueError, match="tail"):
        validate.kernel_train_quality(steps=3, device="cpu", cfg=TINY, samples=800, tail=0)


def test_study_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate.kernel_train_quality(steps=1)
