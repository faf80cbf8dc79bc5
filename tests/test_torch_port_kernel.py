"""The plain versions of the whole-separator kernel (K1) against the JAX
package's plain references, on the CPU.

The CUDA kernel itself runs only on the card (``test_torch_port_cuda.py``
and ``test_torch_port_cuda_paths.py``); here its plain version, which a CPU tensor selects,
is held against the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import make_pair, waves

from audio_only_speech_separation_tpu.models.convtasnet import make_delayed_train_apply
from audio_only_speech_separation_tpu.ops.pallas.convtasnet_backward import tcn_chain_xla
from audio_only_speech_separation_tpu_torch.models.convtasnet import fused_inference_forward
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import tcn_chain_reference

torch.set_num_threads(2)


def _chain_inputs(seed, nb=4, C=128, H=256, B=2, T=301):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1s = (rng.standard_normal((nb, C, H)) / np.sqrt(C)).astype(np.float32)
    wsgs = (rng.standard_normal((nb, H, C)) / np.sqrt(H)).astype(np.float32)
    vecs = (0.3 * rng.standard_normal((nb, 8, H))).astype(np.float32)
    vecs[:, 2] += 1.0  # gLN-1 gamma around 1
    vecs[:, 7] = 0.0  # unused row
    cs = (0.1 * rng.standard_normal((nb, 2, C))).astype(np.float32)
    alphas = rng.uniform(0.05, 1.5, size=(nb, 2)).astype(np.float32)
    return x, w1s, wsgs, vecs, cs, alphas, tuple(2**i for i in range(nb))


def test_tcn_chain_reference_matches_jax_oracle():
    """Both chains round matmul operands and y to bf16 and keep f32
    statistics; they differ in tap form (normalised taps here, folded taps
    with edge corrections there) and summation order, so y agrees to bf16
    rounding: atol 5e-2, rtol 2e-2, as the JAX package's own kernel-vs-
    oracle check (tests/test_tcn_backward.py)."""
    x, w1s, wsgs, vecs, cs, alphas, dils = _chain_inputs(0)
    bf = jnp.bfloat16
    want = tcn_chain_xla(jnp.asarray(x, bf), jnp.asarray(w1s, bf), jnp.asarray(wsgs, bf),
                         jnp.asarray(vecs), jnp.asarray(cs), jnp.asarray(alphas), dils)
    want = np.asarray(want.astype(jnp.float32))
    tb = torch.bfloat16
    got = tcn_chain_reference(torch.from_numpy(x).to(tb), torch.from_numpy(w1s).to(tb),
                              torch.from_numpy(wsgs).to(tb), torch.from_numpy(vecs),
                              torch.from_numpy(cs), torch.from_numpy(alphas), dils)
    assert got.dtype == tb
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize(
    "overrides,T",
    [({}, 4000), ({"activate": "sigmoid"}, 3999), ({"num_spks": 3, "X": 3}, 4321)],
)
def test_plain_separator_meets_the_validator_rule(overrides, T):
    """fused_inference_forward on a CPU tensor (the kernel's plain version)
    against the f32 JAX model: max error <= 1.5 * (the JAX package's plain
    form of K1's algebra, make_delayed_train_apply, vs f32) + 1e-3, the
    rule of scripts/validate_pallas.py:148."""
    jm, params, tm = make_pair(seed=7, **overrides)
    x = waves(8, 2, T)
    ref = np.asarray(jax.jit(jm.apply)(params, x))
    pb = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    delayed = np.asarray(
        jax.jit(make_delayed_train_apply(jm))(pb, jnp.asarray(x, jnp.bfloat16)), np.float32
    )
    scale = np.abs(delayed - ref).max()
    with torch.no_grad():
        got = fused_inference_forward(tm, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= 1.5 * scale + 1e-3, (err, scale)
