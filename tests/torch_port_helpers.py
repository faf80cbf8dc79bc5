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
