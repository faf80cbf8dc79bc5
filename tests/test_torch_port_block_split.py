"""The split of a TCN block that the separator (K1) and chain-forward (K2)
CUDA kernels compute, as a CPU oracle (``_block_split_reference``): a
statistics pass that keeps no hidden state, then a tap pass that
recomputes h per 64-frame tile from the block's bf16 input, in the three
windows of rows t - d, t and t + d, zeroed outside [0, T') after gLN-1.

It is held to the plain block (``_block_reference``) within f32 rounding,
and to the JAX package's chain oracle (``tcn_chain_xla``, one block) within
the JAX package's kernel-vs-oracle tolerance, at the edges of the kernels'
tiling: a dilation of at least T', a dilation of one tile, T' = 1, T' not a
multiple of 64, a batch of one, H 128 and 256.

Also the layout in which the wrappers hand W1^T and wsg^T to the kernels
(``_core_w1``, ``_core_wsg``): each element where the kernels' wgmma
operand layout (``core_index`` in csrc/convtasnet_separator.cu) expects it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.ops.pallas.convtasnet_backward import tcn_chain_xla
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
    _block_reference,
    _block_split_reference,
    _core_w1,
    _core_wsg,
)

torch.set_num_threads(2)


def _block_inputs(B, T, H, seed):
    """One block's inputs in the JAX backward test's distribution
    (tests/test_tcn_backward.py:36), as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, T, 128)).astype(np.float32)
    w1 = (rng.normal(size=(128, H)) * 0.1).astype(np.float32)
    wsg = (rng.normal(size=(H, 128)) * 0.1).astype(np.float32)
    vec = (rng.normal(size=(8, H)) * 0.3).astype(np.float32)
    vec[7] = 0.0
    c = (rng.normal(size=(2, 128)) * 0.1).astype(np.float32)
    alpha = (np.abs(rng.normal(size=(2,))) * 0.3 + 0.05).astype(np.float32)
    return y, w1, wsg, vec, c, alpha


def _torch(args):
    bf = torch.bfloat16
    y, w1, wsg, vec, c, alpha = (torch.from_numpy(a) for a in args)
    return y.to(bf), w1.to(bf), wsg.to(bf), vec, c, alpha


# (B, T', H, d): d >= T'; d = 64, one tile; T' = 1; B = 1 with T' % 64 != 0;
# d = 128 across several tiles; d = 1 at H 256; d a little under T'
SPLIT_CASES = [(2, 100, 128, 128), (2, 200, 128, 64), (2, 1, 128, 4), (1, 333, 256, 32),
               (1, 300, 256, 128), (2, 130, 256, 1), (1, 70, 128, 64)]


@pytest.mark.parametrize("B,T,H,d", SPLIT_CASES)
def test_split_oracle_matches_the_plain_block(B, T, H, d):
    """The statistics within f32 rounding (the split sums per tile, then
    the tiles in order), y within one bf16 step of the plain block's (an
    f32 difference in the last bit can round the other way)."""
    ta = _torch(_block_inputs(B, T, H, seed=B * T + H + d))
    y_want, st_want = _block_reference(*ta, d)
    y_got, st_got = _block_split_reference(*ta, d)
    assert y_got.shape == y_want.shape and y_got.dtype == torch.bfloat16
    for name, a, b in zip(("mean1", "rstd1", "mean2", "rstd2"), st_got, st_want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    torch.testing.assert_close(y_got.float(), y_want.float(), rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("B,T,H,d", SPLIT_CASES[:4])
def test_split_oracle_matches_the_jax_chain_oracle(B, T, H, d):
    """One block through the split oracle against tcn_chain_xla with that
    block alone: atol 5e-2, rtol 2e-2 (the JAX package's kernel-vs-oracle
    tolerance; the JAX oracle folds the taps with edge corrections)."""
    args = _block_inputs(B, T, H, seed=B * T + H + d)
    bf = jnp.bfloat16
    y, w1, wsg, vec, c, alpha = args
    want = tcn_chain_xla(jnp.asarray(y, bf), jnp.asarray(w1[None], bf), jnp.asarray(wsg[None], bf),
                         jnp.asarray(vec[None]), jnp.asarray(c[None]), jnp.asarray(alpha[None]), (d,))
    got, _ = _block_split_reference(*_torch(args), d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2, rtol=2e-2)


def _core_index(r, k, K):
    """csrc/convtasnet_separator.cu::core_index: element (r, k) of a [rows][K]
    tile of 8 x 8 core matrices, K fastest."""
    return ((r >> 3) * (K >> 3) + (k >> 3)) * 64 + (r & 7) * 8 + (k & 7)


@pytest.mark.parametrize("nb,H", [(1, 128), (3, 256), (2, 512)])
def test_core_layout_of_the_block_weights(nb, H):
    """_core_w1 and _core_wsg are permutations of W1 and wsg: sub-chunk s of
    W1^T (hidden channels 64 s .. +64 as rows, the 128 input channels as
    k) and of wsg^T (the 128 output channels as rows, hidden channels 64 s
    .. +64 as k) lie contiguously in the core layout."""
    rng = np.random.default_rng(nb + H)
    w1 = torch.from_numpy(rng.standard_normal((nb, 128, H)).astype(np.float32)).to(torch.bfloat16)
    wsg = torch.from_numpy(rng.standard_normal((nb, H, 128)).astype(np.float32)).to(torch.bfloat16)
    a, b = _core_w1(w1), _core_wsg(wsg)
    assert a.is_contiguous() and b.is_contiguous() and a.numel() == w1.numel() == b.numel()
    a, b = a.reshape(nb, H // 64, 64 * 128), b.reshape(nb, H // 64, 128 * 64)
    blk, sub, r, k = np.meshgrid(np.arange(nb), np.arange(H // 64), np.arange(64), np.arange(128),
                                 indexing="ij")
    assert torch.equal(a[blk, sub, _core_index(r, k, 128)], w1[blk, k, 64 * sub + r])
    blk, sub, n, k = np.meshgrid(np.arange(nb), np.arange(H // 64), np.arange(128), np.arange(64),
                                 indexing="ij")
    assert torch.equal(b[blk, sub, _core_index(n, k, 64)], wsg[blk, 64 * sub + k, n])
