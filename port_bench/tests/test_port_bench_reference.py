"""The plain references: independent of the port, JAX and the JAX
package; in agreement with the port's modules at small widths on the CPU;
their FLOP formulas against FlopCounterMode; and the control, the
reference in float8, coming out as not correct at a size a test run
holds."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import calibrate, harness
from port_bench.reference import common, convtasnet, tasnet_dprnn
from port_bench.tests.small import SIZES, cell_names, config_names, small_cell, small_config

REF_DIR = Path(harness.HERE) / "reference"
SEED = 2**31 + 5


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in REF_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "audio_only_speech_separation_tpu",
                                               "audio_only_speech_separation_tpu_torch"), (path.name, n)
    code = ("import sys; import port_bench.reference.convtasnet, port_bench.reference.tasnet_dprnn; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=harness.CHECKOUT).stdout
    for bad in ("jax", "jaxlib", "flax", "audio_only_speech_separation_tpu", "audio_only_speech_separation_tpu_torch"):
        assert f"'{bad}'" not in out


CONFIGS = config_names()


def _model_and_sd(config, seed=3):
    cfg, ref = small_config(config)
    sd = harness.make_state_dict(ref, cfg["model_args"], seed, torch.device("cpu"))
    return cfg, ref, harness.build_model(cfg, sd, "cpu"), sd


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_forward_is_the_ports(config):
    cfg, ref, model, sd = _model_and_sd(config)
    x = torch.randn(2, 4001, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        want, got = model.eval()(x), ref.forward(sd, x, cfg["model_args"])
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_gradients_are_the_ports(config):
    """The reference's loss and gradients against autograd through the
    port's float32 module and loss."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr

    cfg, ref, model, sd = _model_and_sd(config)
    g = torch.Generator().manual_seed(2)
    src = torch.randn(2, cfg["n_src"], 2003, generator=g) * 0.05
    mix = src.sum(1)
    thr = cfg["train"]["threshold_byloss"]
    loss = PITLossWrapper(pairwise_neg_snr, threshold_byloss=thr)(model.train()(mix), src)
    loss.backward()
    params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    ref_loss = common.pit_loss(ref.forward(params, mix, cfg["model_args"]), src, thr)
    grads = torch.autograd.grad(ref_loss, list(params.values()))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-4
    for (k, p), gr in zip(model.named_parameters(), grads):
        assert torch.allclose(p.grad, gr, rtol=1e-3, atol=1e-6 * gr.abs().max() + 1e-12), k


@pytest.mark.parametrize("ref,cfg,T", [
    (convtasnet, dict(N=64, L=16, B=32, H=64, P=3, X=3, R=2, num_spks=3), 3001),
    (tasnet_dprnn, dict(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=2, num_spk=2, block_size=10), 1203),
    (tasnet_dprnn, dict(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=2, num_spk=2, block_size=10), 800)])
def test_flop_formula_is_flopcountermodes(ref, cfg, T):
    """The formula counts exactly the products FlopCounterMode counts in
    the reference's forward (no norm, gate or elementwise FLOPs in
    either)."""
    sd = {n: torch.randn(s) for n, s, *_ in ref.param_shapes(cfg)}
    counter = FlopCounterMode(display=False)
    with counter:
        ref.forward(sd, torch.randn(2, T), cfg)
    assert counter.get_total_flops() == 2 * ref.forward_flops(cfg, T)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    y = common.fp8(x)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0.01 < rel.max() <= 2 ** -4 + 1e-6


@pytest.mark.parametrize("name", cell_names())
def test_control_is_not_correct(name):
    """The control, the reference with its products in float8 e4m3 in the
    program's place, fails at least one of the cell's limits."""
    cell = small_cell(name)
    cpu = torch.device("cpu")
    if cell.traffic["mode"] == "serve":
        checks = calibrate.control_serve(cell, SEED, cpu)
    else:
        checks, _ = calibrate.control_train(cell, SEED, cpu)
    assert any(checks[k] > cell.limits[k] for k in cell.limits), checks


def test_small_sizes_are_cut_from_the_published():
    """Every configuration has its small sizes, and they name only keys of
    the configuration and of a traffic mix of each mode."""
    traffic = [harness.load_json(p) for p in (harness.HERE / "traffic").glob("*.json")]
    for name in CONFIGS:
        cut = harness.load_json(SIZES / f"{name}.json")
        cfg = harness.load_json(harness.HERE / "configs" / f"{name}.json")
        assert set(cut["model_args"]) <= set(cfg["model_args"])
        for mode in ("serve", "train"):
            assert any(set(cut[mode]) <= set(t) for t in traffic if t["mode"] == mode)
