"""ConvTasNet's three training forms in the port against the JAX package, on
the CPU (mirroring ``tests/test_channels_last.py:116-200``):

- ``channels_last=True``: the same ``state_dict`` as the channels-first
  model, its forward and gradients, and the JAX ``channels_last`` forward;
- ``make_delayed_train_apply``: the JAX function's delayed-norm algebra,
  its output and gradients on the same bf16 weights;
- ``make_fused_train_apply``: K1's plain version (a CPU tensor) as the
  primal against the JAX model on bf16-rounded weights, and the backward
  (the plain bf16 module's) against ``jax.vjp`` of the JAX model at those
  weights (the JAX package's own fused form returns None off a TPU);
- each form raises outside its envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import make_pair, waves

from audio_only_speech_separation_tpu.models import ConvTasNet as JConvTasNet
from audio_only_speech_separation_tpu.models.convtasnet import make_delayed_train_apply as jax_delayed
from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import (
    make_delayed_train_apply,
    make_fused_train_apply,
)
from audio_only_speech_separation_tpu_torch.ops.conv import depthwise_conv_channels_last
from audio_only_speech_separation_tpu_torch.train import bf16_forward
from audio_only_speech_separation_tpu_torch.utils.jax_import import convtasnet_from_jax

torch.set_num_threads(2)
BF = torch.bfloat16


def sisnr(a, b):
    a = a - a.mean(-1, keepdims=True)
    b = b - b.mean(-1, keepdims=True)
    proj = (a * b).sum(-1, keepdims=True) / (b * b).sum(-1, keepdims=True) * b
    return 10 * np.log10((proj**2).sum(-1) / (((a - proj) ** 2).sum(-1) + 1e-12))


def bf16_params(model):
    return {k: v.detach().to(BF).requires_grad_() for k, v in model.named_parameters()}


def port_grads(jax_grads, cfg):
    """The JAX gradient tree by the port's parameter names."""
    return convtasnet_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jax_grads),
                               cfg["R"], cfg["X"])


def cosine(a, b):
    return float((a.ravel() @ b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("k,dilation,padding", [(3, 1, 1), (3, 4, 4), (3, 2, 4), (5, 3, 0)])
def test_depthwise_conv_channels_last_is_the_conv(k, dilation, padding):
    conv = torch.nn.Conv1d(6, 6, k, dilation=dilation, padding=padding, groups=6)
    x = torch.randn(2, 6, 40)
    want = conv(x).transpose(1, 2)
    got = depthwise_conv_channels_last(conv, x.transpose(1, 2))
    np.testing.assert_allclose(got.detach(), want.detach(), rtol=1e-5, atol=1e-6)


CL = dict(N=32, L=16, B=32, H=32, P=3, X=2, R=1, num_spks=2, sample_rate=8000)


@pytest.mark.parametrize("activate", ["relu", "softmax"])
def test_channels_last_forward_and_gradients(activate):
    """Same ``state_dict`` (keys and shapes) as the channels-first model; its
    forward within 2e-5 of the output's scale of the channels-first port's
    and of the JAX ``channels_last=True`` model's, and its parameter
    gradients within rtol 1e-4, atol 1e-6 of the channels-first port's (the
    JAX package's own channels-last tolerances)."""
    jm, params, cf = make_pair(seed=1, **CL, activate=activate)
    cl = ConvTasNet(**dict(CL, activate=activate), channels_last=True)
    assert {k: v.shape for k, v in cl.state_dict().items()} == {k: v.shape for k, v in cf.state_dict().items()}
    cl.load_state_dict(cf.state_dict())
    x = waves(0, 2, 3210)
    want = np.asarray(jax.jit(JConvTasNet(**dict(CL, activate=activate), channels_last=True).apply)(params, x))
    xt = torch.from_numpy(x)
    out_cf, out_cl = cf(xt), cl(xt)
    scale = np.abs(want).max()
    assert np.abs(out_cl.detach().numpy() - out_cf.detach().numpy()).max() <= 2e-5 * scale
    assert np.abs(out_cl.detach().numpy() - want).max() <= 2e-5 * scale
    tgt = torch.from_numpy(np.random.default_rng(1).standard_normal(want.shape).astype(np.float32))
    ((out_cf - tgt) ** 2).mean().backward()
    ((out_cl - tgt) ** 2).mean().backward()
    grads = dict(cf.named_parameters())
    for k, p in cl.named_parameters():
        np.testing.assert_allclose(p.grad, grads[k].grad, rtol=1e-4, atol=1e-6, err_msg=k)


DELAYED = dict(N=64, L=16, B=128, H=64, P=3, X=3, R=1, num_spks=2, sample_rate=8000)


@pytest.mark.parametrize("activate", ["relu", "softmax"])
def test_delayed_form_matches_jax(activate):
    """The delayed form against the JAX ``make_delayed_train_apply`` on the
    same bf16 weights and bf16 wave: both round the tap chain to bf16, at
    other points (XLA fuses elementwise bf16 ops), so the outputs agree to
    bf16 rounding (SI-SNR above 35 dB; 44 measured) and the gradients per
    parameter in direction (cosine above 0.99) and, over all parameters,
    within 3 % (relative l2)."""
    cfg = dict(DELAYED, activate=activate)
    jm, params, tm = make_pair(seed=2, **cfg)
    x = waves(1, 2, 1605)
    xb = jnp.asarray(x, jnp.bfloat16)
    jf = jax.jit(jax_delayed(jm))
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jf(pb, xb), np.float32)
    tp = bf16_params(tm)
    out = make_delayed_train_apply(tm)(tp, torch.from_numpy(x).to(BF))
    assert out.dtype == BF and out.shape == want.shape
    assert sisnr(out.float().detach().numpy(), want).min() > 35.0
    tgt = np.random.default_rng(5).standard_normal(want.shape).astype(np.float32)
    ((out.float() - torch.from_numpy(tgt)) ** 2).mean().backward()
    jg = port_grads(jax.jit(jax.grad(lambda p: jnp.mean((jf(p, xb).astype(jnp.float32) - tgt) ** 2)))(pb), cfg)
    got = {k: v.grad.float().numpy() for k, v in tp.items()}
    for k, g in got.items():
        assert np.isfinite(g).all() and cosine(g, jg[k]) > 0.99, k
    flat_got = np.concatenate([got[k].ravel() for k in got])
    flat_want = np.concatenate([jg[k].ravel() for k in got])
    assert np.linalg.norm(flat_got - flat_want) <= 0.03 * np.linalg.norm(flat_want)


def test_fused_form_matches_the_jax_model_and_its_vjp():
    """K1's plain version as the primal against the JAX model on
    bf16-rounded f32 weights (SI-SNR above 30 dB, the JAX package's own bar,
    ``tests/test_channels_last.py:197``), and the gradients, the plain bf16
    module's, against ``jax.vjp`` of the JAX model at those weights (cosine
    above 0.99 per parameter, relative l2 under 0.1 each: bf16 against f32
    arithmetic; 0.04 measured).  The backward is the plain bf16 module's:
    bit for bit the Trainer's plain bf16 path's gradients.  Only the
    parameters and the wave are saved for it."""
    jm, params, tm = make_pair(seed=3)
    x = waves(2, 2, 4000)
    rounded = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)), params)
    want = np.asarray(jax.jit(jm.apply)(rounded, x))
    tp = bf16_params(tm)
    out = make_fused_train_apply(tm)(tp, torch.from_numpy(x).to(BF))
    assert out.dtype == BF and out.shape == want.shape
    assert len(out.grad_fn.saved_tensors) == len(tp) + 1
    assert sisnr(out.float().detach().numpy(), want).min() > 30.0
    tgt = np.random.default_rng(6).standard_normal(want.shape).astype(np.float32)
    ((out.float() - torch.from_numpy(tgt)) ** 2).mean().backward()
    cot = jnp.asarray(2.0 * (want - tgt) / tgt.size)  # d mean((y - tgt)^2) / dy at the JAX output
    jg = port_grads(jax.jit(lambda p: jax.vjp(lambda q: jm.apply(q, x), p)[1](cot)[0])(rounded), dict(R=1, X=2))
    for k, v in tp.items():
        g = v.grad.float().numpy()
        assert cosine(g, jg[k]) > 0.99, k
        assert np.linalg.norm(g - jg[k]) <= 0.1 * np.linalg.norm(jg[k]), k

    plain = bf16_params(tm)
    est = torch.func.functional_call(tm, plain, (torch.from_numpy(x).to(BF),))
    # the same cotangent as the fused arm's: d mean((out - tgt)^2) / d out at the fused output
    cot = (2.0 * (out.float() - torch.from_numpy(tgt)) / tgt.size).to(BF).detach()
    est.backward(cot)
    tp2 = bf16_params(tm)
    out2 = make_fused_train_apply(tm)(tp2, torch.from_numpy(x).to(BF))
    out2.backward(cot)
    for k in tp2:
        assert torch.equal(tp2[k].grad, plain[k].grad), k


def test_fused_form_under_the_trainer_cast_policy():
    """``bf16_forward`` with the fused form: the f32 estimate of K1's plain
    version, and gradients on the f32 parameters (through the casts)."""
    _, _, tm = make_pair(seed=4)
    forward = bf16_forward(tm, apply_fn=make_fused_train_apply(tm))
    est = forward(torch.from_numpy(waves(3, 1, 2000)))
    assert est.dtype == torch.float32
    est.square().mean().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in tm.parameters())


def test_each_form_raises_outside_its_envelope():
    """Where the JAX package returns None (or asserts), the port raises."""
    for bad in (dict(norm="cLN"), dict(causal=True)):
        with pytest.raises(ValueError, match="channels_last"):
            ConvTasNet(**dict(CL, **bad), channels_last=True)
    for bad in (dict(causal=True), dict(norm="cLN"), dict(P=5), dict(H=128)):
        with pytest.raises(ValueError, match="delayed"):
            make_delayed_train_apply(ConvTasNet(**dict(DELAYED, **bad)))
    for bad in (dict(activate="softmax"), dict(N=64, H=64), dict(causal=True)):
        with pytest.raises(ValueError, match="envelope"):
            make_fused_train_apply(make_pair(seed=0, **bad)[2])
