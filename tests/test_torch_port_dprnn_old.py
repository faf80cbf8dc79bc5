"""The port's DPRNNTasNet (the legacy DPRNN model) against the JAX package
on the CPU, in float32: the dual-path core ``OldDPRNN`` in its
bidirectional, one-direction-column and ``full_causal`` (cLN, one-direction
LSTMs) forms, the whole model, the weight converter both ways, a
JAX-written checkpoint served through the port, one train step's loss and
gradients, and the LSTM kernels' launches a call.

Tolerance: rtol = atol = 1e-5 on the core; the whole model within 1e-4 of
its output's scale (float32, as the TasNet tests)."""

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import DPRNNTasNet as JDPRNNTasNet
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.models.dprnn_old import OldDPRNN as JOldDPRNN
from audio_only_speech_separation_tpu.models.dprnn_old import SingleRNNProj as JSingleRNNProj
from audio_only_speech_separation_tpu.utils.torch_import import convert_dprnn_tasnet
from audio_only_speech_separation_tpu_torch.models import DPRNNTasNet, from_pretrain
from audio_only_speech_separation_tpu_torch.models.dprnn_old import OldDPRNN, SingleRNNProj
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch, serve
from audio_only_speech_separation_tpu_torch.utils.jax_import import (
    dprnn_tasnet_from_jax,
    old_dprnn_from_jax,
    single_rnn_proj_from_jax,
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
# small widths, two layers, 8-frame segments (win 4 ms at 8 kHz: 32 samples, 17 bases)
SMALL = dict(feature_dim=16, hidden_dim=16, sample_rate=SR, win=4, layer=2, segment_size=8)
TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


_PAIR = {}


def dprnn_pair():
    """(JAX model, its params as numpy, port model with the same weights)."""
    if not _PAIR:
        jm = JDPRNNTasNet(**SMALL)
        params, tm = port_pair(jm, DPRNNTasNet(**SMALL), lambda p: dprnn_tasnet_from_jax(p, 2), 400)
        _PAIR["pair"] = (jm, params, tm)
    return _PAIR["pair"]


@pytest.mark.parametrize("bidirectional,full_causal", [(True, False), (False, False), (True, True)],
                         ids=["bidirectional", "one_direction_columns", "full_causal"])
def test_old_dprnn_core_matches_jax(bidirectional, full_causal):
    """``OldDPRNN`` on [B, N, K, S], two layers: rows and columns through
    ProjRNN, gLN (or cLN over the K-major chunk positions with one-direction
    LSTMs where causal), the output 1x1; within 1e-5."""
    rng = np.random.default_rng(int(bidirectional) + 2 * int(full_causal))
    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32)
    jm = JOldDPRNN(8, 12, 34, num_layers=2, bidirectional=bidirectional, full_causal=full_causal)
    params = draw_tree(jm.init(jax.random.PRNGKey(0), x), np.random.default_rng(9))
    want = np.asarray(jm.apply(params, x))
    core = OldDPRNN(8, 12, 34, num_layers=2, bidirectional=bidirectional, full_causal=full_causal)
    core.load_state_dict({k: torch.from_numpy(v) for k, v in old_dprnn_from_jax(params, 2).items()})
    with torch.no_grad():
        np.testing.assert_allclose(core(t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "one_direction"])
def test_single_rnn_proj_matches_jax(bidirectional):
    """``SingleRNNProj``, the module ``OldDPRNN`` builds for its rows and
    columns, from a JAX ``SingleRNNProj``'s variables through
    ``single_rnn_proj_from_jax`` (look2hear's ``rnn.*`` and ``proj.*``
    keys): [B, T, N] -> [B, T, N] within 1e-5."""
    rng = np.random.default_rng(30 + int(bidirectional))
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    jm = JSingleRNNProj(8, 12, bidirectional=bidirectional)
    params = draw_tree(jm.init(jax.random.PRNGKey(0), x), np.random.default_rng(31))
    want = np.asarray(jm.apply(params, x))
    m = SingleRNNProj(8, 12, bidirectional=bidirectional)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in single_rnn_proj_from_jax(params).items()})
    assert all(isinstance(r, SingleRNNProj) for r in (*OldDPRNN(8, 12, 34).row_rnn, *OldDPRNN(8, 12, 34).col_rnn))
    with torch.no_grad():
        np.testing.assert_allclose(m(t(x)).numpy(), want, **TOL)


def test_dprnn_tasnet_matches_jax():
    """The whole model, same weights, B=2 x 0.25 s: within 1e-4 of the
    output's scale; a 1-D input comes back without the batch axis."""
    jm, params, tm = dprnn_pair()
    x = np.random.default_rng(1).standard_normal((2, 2001)).astype(np.float32)
    apply = jax.jit(jm.apply)
    with torch.no_grad():
        assert_close(tm(t(x)).numpy(), np.asarray(apply(params, x)))
        assert_close(tm(t(x[1])).numpy(), np.asarray(apply(params, x[1])))


def test_dprnn_tasnet_weights_round_trip():
    """convert_dprnn_tasnet(dprnn_tasnet_from_jax(p)) gives p back, leaf for leaf."""
    _, params, _ = dprnn_pair()
    back = convert_dprnn_tasnet(dprnn_tasnet_from_jax(params, 2), layer=2)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path], np.float32), leaf), path


def test_jax_checkpoint_serves_through_the_port(tmp_path):
    """A DPRNNTasNet checkpoint the JAX package wrote loads through
    ``from_pretrain`` and serves through ``serve`` on the CPU, each request
    against the JAX model on serve's padded batches; with bf16 on the card
    it would be served as "kernels"."""
    jm, params, _ = dprnn_pair()
    ckpt = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), ckpt)
    model = from_pretrain(ckpt, device="cpu")
    assert isinstance(model, DPRNNTasNet) and model.layer == 2 and model.segment_size == 8
    assert choose_dispatch(model, True, "cuda") == "kernels"
    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (5000, 3100)]
    est = serve(model, wavs, use_bf16=True, device="cpu", bucket_seconds=1.0, batch_size=1)
    apply = jax.jit(jm.apply)
    for i, w in enumerate(wavs):
        mix = np.zeros((1, SR), np.float32)
        mix[0, : len(w)] = w
        assert_close(est[i], np.asarray(apply(params, mix))[0, :, : len(w)])


def test_f32_train_step_matches_jax():
    """One f32 train step (PIT pairwise neg-SNR) of the port's DPRNNTasNet
    against ``jax.value_and_grad`` of the JAX model on the same weights."""
    model = perturbed(DPRNNTasNet(**SMALL, generator=torch.Generator().manual_seed(5)), 5)
    rng = np.random.default_rng(6)
    sources = (0.3 * rng.standard_normal((2, 2, 1600))).astype(np.float32)
    train_step_against_jax(JDPRNNTasNet(**SMALL), model, lambda sd: convert_dprnn_tasnet(sd, layer=2),
                           sources.sum(1), sources)


def test_kernel_launches_a_call(monkeypatch):
    """With the kernels' dispatch taken (as for bf16 on the card), each
    layer's row and column LSTM is one K6 launch at any batch (an input of
    width 16 never takes K5); the kernel form, here with the plain
    versions, within 1e-5 of the plain form."""
    _, _, tm = dprnn_pair()
    x = t(np.random.default_rng(8).standard_normal((1, 800)))
    with torch.no_grad():
        want = tm(x)
    # 800 samples: 106 frames, 28 chunks of 8 -> rows 28, columns 8 sequences per utterance
    for batch, counts in ((1, {"K4": 0, "K5": 0, "K6": 4}), (5, {"K4": 0, "K5": 0, "K6": 4}),
                          (17, {"K4": 0, "K5": 0, "K6": 4})):
        got, launched = count_kernel_launches(monkeypatch, lambda: tm(x.repeat(batch, 1)))
        assert launched == counts
        np.testing.assert_allclose(got[:1].numpy(), want.numpy(), **TOL)
