"""Shared set-up for the PyTorch port's tests: small ConvTasNet configs,
seeded random weights in the JAX layout, and the matching port model."""

import jax
import numpy as np
import torch

from audio_only_speech_separation_tpu.models import ConvTasNet as JConvTasNet
from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.utils.jax_import import convtasnet_from_jax

# small widths, kernel envelope (N == H, B == 128, L == 16)
SMALL = dict(N=128, L=16, B=128, H=128, P=3, X=2, R=1, norm="gLN", num_spks=2,
             activate="relu", causal=False, sample_rate=8000)


def random_params(model, rng, T=400):
    """The JAX model's parameter tree with every leaf redrawn from ``rng``
    (numpy): random gLN/cLN affines, biases and PReLU slopes, some above 1."""
    params = model.init(jax.random.PRNGKey(0), np.zeros((1, T), np.float32))

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = np.shape(leaf)
        if name == "alpha":
            return rng.uniform(0.05, 1.5, size=shape).astype(np.float32)
        if name in ("gamma", "gain"):
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name in ("beta", "bias"):
            return (0.2 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(seed=0, **overrides):
    """(JAX model, JAX params as numpy, port model with the same weights)."""
    cfg = dict(SMALL, **overrides)
    jm = JConvTasNet(**cfg)
    params = as_numpy(random_params(jm, np.random.default_rng(seed)))
    tm = ConvTasNet(**cfg)
    sd = convtasnet_from_jax(params, cfg["R"], cfg["X"])
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return jm, params, tm.eval()


def waves(seed, B, T):
    return np.random.default_rng(seed).standard_normal((B, T)).astype(np.float32)


def perturbed(model, seed, scale=0.1):
    """``model`` with every parameter moved by ``scale``-sized seeded normal
    noise (norm affines, biases and PReLU slopes included), in eval mode."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32)))
    return model.eval()


def state_numpy(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def assert_close(got, want, rel=1e-4):
    """float32 in both packages: max error <= ``rel`` of the output's scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def assert_same_tree(a, b):
    flat_a, tree_a = jax.tree_util.tree_flatten(a)
    flat_b, tree_b = jax.tree_util.tree_flatten(b)
    assert tree_a == tree_b and all(np.array_equal(x, y) for x, y in zip(flat_a, flat_b))


def draw_tree(params, rng):
    """Every leaf of a JAX parameter tree redrawn from ``rng`` (numpy): norm
    scales and gate weights near 1, biases 0.1-scaled, PReLU slopes in
    (0.05, 1.5), matrices normal / sqrt(fan-in)."""
    def leaf(path, x):
        name, shape = str(path[-1].key), np.shape(x)
        if name == "alpha":
            return rng.uniform(0.05, 1.5, size=shape).astype(np.float32)
        if name in ("gamma", "scale", "gain") or (name == "weight" and len(shape) == 1):
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) <= 1 or name == "bias":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map(np.asarray, jax.tree_util.tree_map_with_path(leaf, params))


def port_pair(jax_model, port_model, convert, T, seed=3):
    """(JAX params as numpy, ``port_model`` in eval mode with the same
    weights): the JAX tree drawn by ``draw_tree``, carried by ``convert``
    (a ``*_from_jax`` converter of the port), every key of the port's
    ``state_dict`` filled."""
    params = jax_model.init(jax.random.PRNGKey(0), np.zeros((1, T), np.float32))
    params = draw_tree(params, np.random.default_rng(seed))
    sd = convert(params)
    assert set(sd) == set(port_model.state_dict())
    port_model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return params, port_model.eval()


def train_step_against_jax(jax_model, model, to_jax, mix, sources):
    """One f32 PIT (pairwise neg-SNR) train step's loss and gradients of the
    port ``model`` (train mode) against ``jax.value_and_grad`` of the JAX
    model's ``apply(train=True)`` on the same weights, carried to the JAX
    tree by ``to_jax`` (the JAX package's ``convert_*`` on a port state dict
    of numpy arrays).  Bounds: the loss within 1e-5 relative, each
    gradient within 1e-3 relative l2 of its own norm or 1e-5 of the norm of
    all of them, all together within 1e-4."""
    import jax.numpy as jnp

    from audio_only_speech_separation_tpu import losses as jlosses
    from audio_only_speech_separation_tpu_torch import losses

    params = to_jax(state_numpy(model))
    jloss = jlosses.PITLossWrapper(jlosses.pairwise_neg_snr, pit_from="pw_mtx")

    def jax_loss(p):
        return jloss(jax_model.apply(p, jnp.asarray(mix), train=True), jnp.asarray(sources))

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(jax.tree_util.tree_map(jnp.asarray, params))
    model.train()
    loss = losses.PITLossWrapper(losses.pairwise_neg_snr, pit_from="pw_mtx")(
        model(torch.from_numpy(mix)), torch.from_numpy(sources))
    loss.backward()
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad.detach().numpy()
        if ".bias_hh_l0" in name:  # converters sum bias_ih + bias_hh: count the gradient once
            np.testing.assert_array_equal(g, grads[name.replace("bias_hh", "bias_ih")])
            g = np.zeros_like(g)
        grads[name] = g

    def flat(tree):
        return {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    got, want = flat(to_jax(grads)), flat(want)
    assert set(got) == set(want)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    total = np.sqrt(sum(np.sum(v * v) for v in want.values()))
    for k in want:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= max(1e-3 * np.linalg.norm(want[k]), 1e-5 * total), (k, err, np.linalg.norm(want[k]))
    g, w = (np.concatenate([d[k].ravel() for k in sorted(want)]) for d in (got, want))
    assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


def count_kernel_launches(monkeypatch, fn):
    """Run ``fn`` as if its tensors were bf16 on the card
    (``kernels.kernel_input`` forced true), with K4 (either entry), K5 and
    K6 replaced by their plain versions counting their calls; returns
    (result, {"K4": n, "K5": n, "K6": n})."""
    from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
    from audio_only_speech_separation_tpu_torch.ops import kernels
    from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
    from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
        attention_bdt_reference,
        attention_packed_reference,
    )
    from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
        bilstm_reference,
        resident_bilstm_reference,
    )

    counts = {"K4": 0, "K5": 0, "K6": 0}

    def counting(label, plain):
        def run(*args):
            counts[label] += 1
            return plain(*args)
        return run

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_attention, "fused_attention_bdt", counting("K4", attention_bdt_reference))
    monkeypatch.setattr(port_attention, "fused_attention_packed", counting("K4", attention_packed_reference))
    monkeypatch.setattr(port_rnn, "fused_bilstm", counting("K5", bilstm_reference))
    monkeypatch.setattr(port_rnn, "resident_bilstm", counting("K6", resident_bilstm_reference))
    with torch.no_grad():
        return fn(), counts
