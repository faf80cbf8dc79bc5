"""The port's Sandglasset against the JAX package on the CPU, in float32:
the channels-last chunking and fold, the resampling helpers, the 4-D
batched-axis attention (plain form, and kernel form with K4's plain
version), an identity-pool and a pooled block, the whole model, the weight
converter both ways, a JAX-written checkpoint served through the port, one
train step's loss and gradients, the kernels' launches a call, and the
residual handed to the blocks' gLNs against the former sums.

Tolerance: rtol = atol = 1e-5 on the ops and modules; the whole model
within 1e-4 of its output's scale (float32, as the TasNet tests)."""

import copy

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import Sandglasset as JSandglasset
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.models.sandglasset import SandglassetBlock as JBlock
from audio_only_speech_separation_tpu.models.sandglasset import fold_chunks as jfold_chunks
from audio_only_speech_separation_tpu.models.sandglasset import unfold_chunks as junfold_chunks
from audio_only_speech_separation_tpu.ops import conv as jconv
from audio_only_speech_separation_tpu.ops import resample as jresample
from audio_only_speech_separation_tpu.ops.attention import _mha_batched_axis1
from audio_only_speech_separation_tpu.utils.torch_import import convert_sandglasset
from audio_only_speech_separation_tpu_torch.models import Sandglasset, from_pretrain
from audio_only_speech_separation_tpu_torch.models.sandglasset import SandglassetBlock, fold_chunks, unfold_chunks
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.attention import (
    MultiheadAttention,
    mha_batched_axis1_kernel_form,
)
from audio_only_speech_separation_tpu_torch.ops.conv import frame_axis1, overlap_add_axis1
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import attention_bdt_reference
from audio_only_speech_separation_tpu_torch.ops.norms import GlobalLayerNorm
from audio_only_speech_separation_tpu_torch.ops.resample import (
    avg_pool1d,
    interpolate_linear_align_corners,
)
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch, serve
from audio_only_speech_separation_tpu_torch.utils.jax_import import (
    sandglasset_block_from_jax,
    sandglasset_from_jax,
)
from torch_port_helpers import (
    assert_close,
    count_kernel_launches,
    draw_tree,
    perturbed,
    port_pair,
    train_step_against_jax,
)

torch.set_num_threads(2)

SR = 8000
# small widths, four blocks (pools 1, 4, 4, 1), 16-frame chunks
SMALL = dict(n_feats=16, bn_chan=16, hid_size=16, chunk_size=16, hop_size=8, n_repeats=4, n_head=2,
             sample_rate=SR)
TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


_PAIR = {}


def sandglasset_pair():
    """(JAX model, its params as numpy, port model with the same weights)."""
    if not _PAIR:
        jm = JSandglasset(**SMALL)
        params, tm = port_pair(jm, Sandglasset(**SMALL), lambda p: sandglasset_from_jax(p, 4), 400)
        _PAIR["pair"] = (jm, params, tm)
    return _PAIR["pair"]


@pytest.mark.parametrize("I,K", [(40, 16), (29, 6), (7, 4), (501, 250)])
def test_unfold_and_fold_chunks_match_jax(I, K):
    """``unfold_chunks`` ([B, D, I] -> channels-last chunks [B, S, K, D]
    with a chunk of padding each side, hop K/2) and ``fold_chunks`` (the
    overlap-add, cropped, halved) against the JAX functions on the same
    input, within 1e-5; folding the unfolded chunks gives the input back
    (every position is covered twice)."""
    rng = np.random.default_rng(I + K)
    x = rng.standard_normal((2, 5, I)).astype(np.float32)
    want, want_len = junfold_chunks(x, K)
    got, got_len = unfold_chunks(t(x), K)
    assert got_len == want_len == I
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    chunks = rng.standard_normal(got.shape).astype(np.float32)
    np.testing.assert_allclose(fold_chunks(t(chunks), I).numpy(), np.asarray(jfold_chunks(chunks, I)), **TOL)
    np.testing.assert_allclose(fold_chunks(got, I).numpy(), x, **TOL)


@pytest.mark.parametrize("T,win,stride", [(40, 16, 8), (29, 6, 4), (250 * 3, 250, 125)])
def test_frame_and_overlap_add_axis1_match_jax(T, win, stride):
    """Channels-last chunking and its fold are layout moves and sums: the
    JAX result, the sums within 1e-5."""
    x = np.random.default_rng(T).standard_normal((2, T, 5)).astype(np.float32)
    frames = frame_axis1(t(x), win, stride)
    want = np.asarray(jconv.frame_axis1(x, win, stride))
    assert np.array_equal(frames.numpy(), want)
    np.testing.assert_allclose(overlap_add_axis1(frames, stride).numpy(),
                               np.asarray(jconv.overlap_add_axis1(want, stride)), **TOL)


@pytest.mark.parametrize("T,size,kernel,stride", [(16, 31, 4, None), (62, 250, 3, 2), (1, 7, 1, None)])
def test_resample_helpers_match_jax(T, size, kernel, stride):
    """``interpolate_linear_align_corners`` (and its matrix) and
    ``avg_pool1d``, with and without a stride apart from the kernel, on
    the last axis and on axis 1 (Sandglasset's layout)."""
    x = np.random.default_rng(size).standard_normal((3, 4, T)).astype(np.float32)
    up = np.asarray(jresample.interpolate_linear_align_corners(x, size))
    pooled = np.asarray(jresample.avg_pool1d(x, kernel, stride))
    np.testing.assert_allclose(interpolate_linear_align_corners(t(x), size).numpy(), up, **TOL)
    np.testing.assert_allclose(avg_pool1d(t(x), kernel, stride).numpy(), pooled, **TOL)
    xt = t(x).transpose(1, 2)  # [3, T, 4], a view
    np.testing.assert_allclose(interpolate_linear_align_corners(xt, size, dim=1).numpy(),
                               up.transpose(0, 2, 1), **TOL)
    np.testing.assert_allclose(avg_pool1d(xt, kernel, stride, dim=1).numpy(), pooled.transpose(0, 2, 1), **TOL)


@pytest.mark.parametrize("B,T,K,E,h", [(2, 9, 5, 16, 2), (1, 13, 3, 32, 4)])
def test_batched_axis1_attention_matches_jax(B, T, K, E, h):
    """Self-attention over axis 1 of [B, T, K, E]: the module's plain form
    (f32 on the CPU), and its kernel form (q, k, v straight into [B*K*h, dh,
    T], the output projection straight back) with K4's plain version, both
    within 1e-5 of the JAX package's ``_mha_batched_axis1`` with the kernel
    off."""
    rng = np.random.default_rng(B * T)
    w_in = (rng.standard_normal((3 * E, E)) / np.sqrt(E)).astype(np.float32)
    b_in = (0.1 * rng.standard_normal(3 * E)).astype(np.float32)
    w_out = (rng.standard_normal((E, E)) / np.sqrt(E)).astype(np.float32)  # JAX [in, out]
    b_out = (0.1 * rng.standard_normal(E)).astype(np.float32)
    x = rng.standard_normal((B, T, K, E)).astype(np.float32)
    want = np.asarray(_mha_batched_axis1(E, h, x, w_in, b_in, w_out, b_out, None, False))
    m = MultiheadAttention(E, h)
    m.load_state_dict({"in_proj_weight": t(w_in), "in_proj_bias": t(b_in), "out_proj.weight": t(w_out.T),
                       "out_proj.bias": t(b_out)})
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(t(x)).numpy(), want, **TOL)
        with kernels.plain_versions():
            got = mha_batched_axis1_kernel_form(t(x), m.in_proj_weight, m.in_proj_bias, m.out_proj.weight,
                                                m.out_proj.bias, h, attention_bdt_reference)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("block_i,skip", [(0, False), (3, True), (1, False), (2, True)],
                         ids=["identity_pool", "identity_pool_skip", "pooled", "pooled_skip"])
def test_sandglasset_block_matches_jax(block_i, skip):
    """A block of a four-block model: blocks 0 and 3 pool by 1 (the 4-D
    attention), 1 and 2 by 4 (pooling and interpolation products), with and
    without the mirrored block's skip; output and skip within 1e-5."""
    rng = np.random.default_rng(block_i)
    B, S, K, D = 2, 5, 16, 16
    x = rng.standard_normal((B, S, K, D)).astype(np.float32)
    kernel = 1 if block_i in (0, 3) else 4
    Q = (K - kernel) // kernel + 1
    sk = rng.standard_normal((B, S, K, D) if kernel == 1 else (B * Q, S, D)).astype(np.float32)
    jb = JBlock(D, 16, 2, block_i=block_i, model_n_block=4, chunk_size=K)
    args = (x, sk) if skip else (x,)
    params = draw_tree(jb.init(jax.random.PRNGKey(0), *args), np.random.default_rng(7))
    want = jb.apply(params, *args)
    block = SandglassetBlock(D, 16, 2, block_i=block_i, model_n_block=4, chunk_size=K)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in sandglasset_block_from_jax(params).items()})
    with torch.no_grad():
        got = block.eval()(*(t(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_sandglasset_matches_jax():
    """The whole model (-5 dB normalisation, chunking, four blocks with
    skips, mask head, decoder), same weights, B=2 x 0.3 s: within 1e-4 of
    the output's scale; a 1-D input comes back without the batch axis."""
    jm, params, tm = sandglasset_pair()
    x = np.random.default_rng(1).standard_normal((2, 2401)).astype(np.float32)
    apply = jax.jit(jm.apply)
    with torch.no_grad():
        assert_close(tm(t(x)).numpy(), np.asarray(apply(params, x)))
        assert_close(tm(t(x[0])).numpy(), np.asarray(apply(params, x[0])))


def test_sandglasset_weights_round_trip():
    """convert_sandglasset(sandglasset_from_jax(p)) gives p back, leaf for leaf."""
    _, params, _ = sandglasset_pair()
    back = convert_sandglasset(sandglasset_from_jax(params, 4), n_repeats=4)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path], np.float32), leaf), path


def test_jax_checkpoint_serves_through_the_port(tmp_path):
    """A Sandglasset checkpoint the JAX package wrote loads through
    ``from_pretrain`` (every constructor argument kept) and serves through
    ``serve`` on the CPU, each request against the JAX model on serve's
    padded batch; with bf16 on the card it would be served as "kernels"."""
    jm, params, _ = sandglasset_pair()
    ckpt = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), ckpt)
    model = from_pretrain(ckpt, device="cpu")
    assert isinstance(model, Sandglasset) and model.n_repeats == 4 and model.mask_act == "sigmoid"
    assert choose_dispatch(model, True, "cuda") == "kernels"
    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (3100, 5000)]
    est = serve(model, wavs, use_bf16=True, device="cpu", bucket_seconds=1.0, batch_size=2)
    mix = np.zeros((2, SR), np.float32)
    for j, w in enumerate(wavs):
        mix[j, : len(w)] = w
    want = np.asarray(jax.jit(jm.apply)(params, mix))
    for j, w in enumerate(wavs):
        assert_close(est[j], want[j, :, : len(w)])


def test_f32_train_step_matches_jax():
    """One f32 train step (PIT pairwise neg-SNR) of the port's Sandglasset
    against ``jax.value_and_grad`` of the JAX model on the same weights."""
    model = perturbed(Sandglasset(**SMALL, generator=torch.Generator().manual_seed(5)), 5)
    rng = np.random.default_rng(6)
    sources = (0.3 * rng.standard_normal((2, 2, 1600))).astype(np.float32)
    train_step_against_jax(JSandglasset(**SMALL), model, lambda sd: convert_sandglasset(sd, n_repeats=4),
                           sources.sum(1), sources)


def test_kernel_launches_a_call(monkeypatch):
    """With the kernels' dispatch taken (as for bf16 on the card), a call
    attends once a block through K4 (the 4-D form in blocks 0 and 3) and
    runs each block's intra BiLSTM through K6 (K5 takes only inputs of
    width 128 or more); the kernel form, here with the plain versions,
    stays within 1e-5 of the plain form."""
    _, _, tm = sandglasset_pair()
    x = t(np.random.default_rng(8).standard_normal((2, 400)))
    with torch.no_grad():
        want = tm(x)
    for batch in (2, 4):  # S = 53 chunks an utterance: 106 and 212 sequences
        xb = x.repeat(batch // 2, 1)
        got, counts = count_kernel_launches(monkeypatch, lambda: tm(xb))
        assert counts == {"K4": 4, "K5": 0, "K6": 4}
        np.testing.assert_allclose(got[:2].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_sites_are_the_old_sums_bit_for_bit(monkeypatch, dtype):
    """The blocks hand their residual to ``intra_norm`` / ``inter_norm``
    (``residual=x``, where K9 adds it on the card); on the CPU the model's
    output is bit for bit that of the former call sites ``x + norm(...)``,
    emulated by a norm that drops the argument and adds afterwards."""
    _, _, tm = sandglasset_pair()
    model = copy.deepcopy(tm).to(dtype)
    x = t(np.random.default_rng(9).standard_normal((2, 1200))).to(dtype)
    with torch.no_grad():
        got = model(x)
        plain = GlobalLayerNorm.forward

        def former(self, y, group=None, residual=None):
            out = plain(self, y, group)
            return out if residual is None else residual + out

        monkeypatch.setattr(GlobalLayerNorm, "forward", former)
        want = model(x)
    assert got.dtype == dtype and torch.equal(got, want)
