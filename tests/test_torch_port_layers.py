"""The port's layer library (``layers/``) against the JAX package's on the
CPU: every class of the JAX ``layers.__all__`` built from the JAX module's
variables through ``layers_from_jax`` and run on the same input (float32,
``rtol=atol=1e-5``); BatchNorm in its training and running-average modes;
the registries ``get_norm`` and ``get_activation`` and ``make_enc_dec``;
``wav_file_separate`` on the same wav and weights; and one bf16 case for
each block that reaches a kernel, through the kernels' plain versions,
against the f32 block under the 1.5x rule."""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import count_kernel_launches, draw_tree, make_pair

import audio_only_speech_separation_tpu.layers as J
from audio_only_speech_separation_tpu.ops.activations import get_activation as jax_get_activation
from audio_only_speech_separation_tpu.ops.norms import get_norm as jax_get_norm
from audio_only_speech_separation_tpu.utils.separator import wav_file_separate as jax_wav_file_separate
from audio_only_speech_separation_tpu_torch import layers as L
from audio_only_speech_separation_tpu_torch.data.audio_io import read_wav, write_wav
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.activations import get_activation
from audio_only_speech_separation_tpu_torch.ops.norms import get_norm
from audio_only_speech_separation_tpu_torch.utils.jax_import import layers_from_jax
from audio_only_speech_separation_tpu_torch.utils.separator import Separator, wav_file_separate

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def fb():
    return J.Filterbank(16, 8, 4), L.Filterbank(16, 8, 4)


# name -> (JAX module, port module, inputs (numpy) from a generator)
CASES = {
    "Encoder": (lambda: J.Encoder(fb()[0]), lambda: L.Encoder(fb()[1]), lambda r: [arr(r, 2, 60)]),
    "Encoder 3-D input": (lambda: J.Encoder(fb()[0]), lambda: L.Encoder(fb()[1]), lambda r: [arr(r, 2, 1, 60)]),
    "Decoder": (lambda: J.Decoder(fb()[0]), lambda: L.Decoder(fb()[1]), lambda r: [arr(r, 2, 16, 14)]),
    "Conv1DBlock gLN": (lambda: J.Conv1DBlock(8, 16, 3, dilation=2), lambda: L.Conv1DBlock(8, 16, 3, dilation=2),
                        lambda r: [arr(r, 2, 8, 30)]),
    "Conv1DBlock cLN": (lambda: J.Conv1DBlock(8, 16, 3, norm_type="cLN"),
                        lambda: L.Conv1DBlock(8, 16, 3, norm_type="cLN"), lambda r: [arr(r, 2, 8, 30)]),
    "Conv1DBlock LN": (lambda: J.Conv1DBlock(8, 16, 5, dilation=3, norm_type="LN"),
                       lambda: L.Conv1DBlock(8, 16, 5, dilation=3, norm_type="LN"), lambda r: [arr(r, 2, 8, 30)]),
    "ConvNorm": (lambda: J.ConvNorm(12, 5, stride=2, groups=12), lambda: L.ConvNorm(12, 12, 5, stride=2, groups=12),
                 lambda r: [arr(r, 2, 12, 31)]),
    "ConvNorm no bias": (lambda: J.ConvNorm(12, 3, use_bias=False), lambda: L.ConvNorm(8, 12, 3, use_bias=False),
                         lambda r: [arr(r, 2, 8, 31)]),
    "ConvNormAct": (lambda: J.ConvNormAct(12, 3), lambda: L.ConvNormAct(8, 12, 3), lambda r: [arr(r, 2, 8, 31)]),
    "FRCNNBlock": (lambda: J.FRCNNBlock(8, 16, 3), lambda: L.FRCNNBlock(8, 16, 3), lambda r: [arr(r, 2, 8, 37)]),
    "SingleRNN": (lambda: J.SingleRNN(12), lambda: L.SingleRNN(10, 12), lambda r: [arr(r, 3, 9, 10)]),
    "SingleRNN bidirectional": (lambda: J.SingleRNN(12, bidirectional=True),
                                lambda: L.SingleRNN(10, 12, bidirectional=True), lambda r: [arr(r, 3, 9, 10)]),
    "LSTMBlockTF": (lambda: J.LSTMBlockTF(12), lambda: L.LSTMBlockTF(10, 12), lambda r: [arr(r, 3, 9, 10)]),
    "TransformerBlockTF": (lambda: J.TransformerBlockTF(16, 4, 32), lambda: L.TransformerBlockTF(16, 4, 32),
                           lambda r: [arr(r, 2, 11, 16)]),
    "TransformerBlockTF no positions": (lambda: J.TransformerBlockTF(16, 2, 24, use_positions=False),
                                        lambda: L.TransformerBlockTF(16, 2, 24, use_positions=False),
                                        lambda r: [arr(r, 2, 11, 16)]),
    "DPRNNBlock": (lambda: J.DPRNNBlock(12), lambda: L.DPRNNBlock(8, 12), lambda r: [arr(r, 2, 8, 6, 5)]),
    "DPRNNBlock one-direction columns": (lambda: J.DPRNNBlock(12, bidirectional=False),
                                         lambda: L.DPRNNBlock(8, 12, bidirectional=False),
                                         lambda r: [arr(r, 2, 8, 6, 5)]),
    "DPRNN": (lambda: J.DPRNN(12, n_repeats=2), lambda: L.DPRNN(8, 12, n_repeats=2), lambda r: [arr(r, 2, 8, 6, 5)]),
    "DPRNN with a head": (lambda: J.DPRNN(12, n_repeats=2, out_channels=20),
                          lambda: L.DPRNN(8, 12, n_repeats=2, out_channels=20), lambda r: [arr(r, 2, 8, 6, 5)]),
    "TAC": (lambda: J.TAC(8, 12), lambda: L.TAC(8, 12), lambda r: [arr(r, 2, 3, 8, 7)]),
    "gLN": (lambda: J.gLN(8), lambda: L.gLN(8), lambda r: [arr(r, 2, 8, 9) + 3.0]),
    "cLN": (lambda: J.cLN(8), lambda: L.cLN(8), lambda r: [arr(r, 2, 8, 9)]),
    "LN": (lambda: J.LN(8), lambda: L.LN(8), lambda r: [arr(r, 2, 8, 9) + 3.0]),
    "PReLU": (lambda: J.PReLU(), lambda: L.PReLU(), lambda r: [arr(r, 2, 8, 9)]),
    "MultiheadAttention": (lambda: J.MultiheadAttention(16, 4), lambda: L.MultiheadAttention(16, 4),
                           lambda r: [arr(r, 2, 11, 16)]),
    "PositionalEncoding": (lambda: J.PositionalEncoding(16), lambda: L.PositionalEncoding(16),
                           lambda r: [arr(r, 2, 11, 16)]),
    "Video1DConv first block": (lambda: J.Video1DConv(8, 12, 3), lambda: L.Video1DConv(8, 12, 3),
                                lambda r: [arr(r, 2, 8, 20)]),
    "Video1DConv": (lambda: J.Video1DConv(8, 12, 3, dilation=2, first_block=False),
                    lambda: L.Video1DConv(8, 12, 3, dilation=2, first_block=False), lambda r: [arr(r, 2, 8, 20)]),
    "Video1DConv no skip": (lambda: J.Video1DConv(8, 8, 5, skip_con=False, first_block=False),
                            lambda: L.Video1DConv(8, 8, 5, skip_con=False, first_block=False),
                            lambda r: [arr(r, 2, 8, 20)]),
    "Concat": (lambda: J.Concat(8, 6, 10), lambda: L.Concat(8, 6, 10), lambda r: [arr(r, 2, 8, 20), arr(r, 2, 6, 7)]),
    "Bottomup": (lambda: J.Bottomup(8, 16, 3), lambda: L.Bottomup(8, 16, 3), lambda r: [arr(r, 2, 8, 29)]),
    "BottomupConcatTopdown": (lambda: J.BottomupConcatTopdown(8, 16, 3), lambda: L.BottomupConcatTopdown(8, 16, 3),
                              lambda r: [arr(r, 2, 8, 29)]),
    "RelativeMultiHeadAttention": (lambda: J.RelativeMultiHeadAttention(16, 4),
                                   lambda: L.RelativeMultiHeadAttention(16, 4), lambda r: [arr(r, 2, 11, 16)]),
    "MultiHeadedSelfAttentionModule": (lambda: J.MultiHeadedSelfAttentionModule(16, 4),
                                       lambda: L.MultiHeadedSelfAttentionModule(16, 4),
                                       lambda r: [arr(r, 2, 11, 16)]),
    "ConformerConvModule": (lambda: J.ConformerConvModule(8, 7), lambda: L.ConformerConvModule(8, 7),
                            lambda r: [arr(r, 2, 13, 8)]),
    "DPRNNLinear": (lambda: J.DPRNNLinear(12), lambda: L.DPRNNLinear(8, 12, 5), lambda r: [arr(r, 2, 8, 6, 5)]),
}
# the names of the JAX ``__all__`` held elsewhere: the filterbank containers
# and the factory below, the STFT library in tests/test_torch_port_stft_lib.py
NOT_MODULES = {"Filterbank", "FreeFB", "make_enc_dec", "get_norm", "get", "get_activation", "bN", "stft", "istft",
               "stft_matmul", "hann_window", "forward_stft", "inverse_stft", "STFT", "iSTFT", "init_window",
               "init_kernel", "mel_filter", "speed_perturb_filter", "splice_feature"}


def jax_variables(jm, inputs, seed=3):
    """The JAX module's variables, every parameter redrawn (``draw_tree``),
    as numpy.  (``Module.init`` called through the class: the JAX
    ``PReLU``'s field ``init`` shadows the method.)"""
    v = flax.linen.Module.init(jm, jax.random.PRNGKey(0), *inputs)
    return {"params": draw_tree(v.get("params", {}), np.random.default_rng(seed)),
            **{k: jax.tree_util.tree_map(np.asarray, c) for k, c in v.items() if k != "params"}}


def port_from(module, variables):
    sd = layers_from_jax(module, variables)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return module.eval()


def assert_tree_close(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def test_every_exported_name_is_the_jax_packages_and_held_here():
    assert L.__all__ == J.__all__
    assert all(hasattr(L, n) for n in J.__all__)
    assert set(J.__all__) <= NOT_MODULES | {c.split()[0] for c in CASES}
    assert L.get is L.get_norm and L.bN is get_norm("bN")


@pytest.mark.parametrize("case", list(CASES))
def test_layer_matches_the_jax_layer(case):
    """The JAX layer's variables carried across by ``layers_from_jax``, the
    same input, f32 within 1e-5."""
    jctor, pctor, make = CASES[case]
    inputs = make(np.random.default_rng(len(case)))
    jm = jctor()
    variables = jax_variables(jm, inputs)
    want = jm.apply(variables, *inputs)
    model = port_from(pctor(), variables)
    with torch.no_grad():
        got = model(*[torch.from_numpy(x) for x in inputs])
    assert_tree_close(got, want)


def test_batchnorm_training_and_running_average_modes():
    """bN against flax's BatchNorm: in training mode the batch statistics
    and their update of the running ones (the mean as flax's; the variance
    with torch's unbiased estimate where flax takes the biased one), in
    eval mode the running statistics."""
    rng = np.random.default_rng(5)
    x = arr(rng, 4, 6, 10) * 2.0 + 1.0
    jm = J.bN(6)
    v = jm.init(jax.random.PRNGKey(0), x)
    v = {"params": draw_tree(v["params"], rng),
         "batch_stats": {"BatchNorm_0": {"mean": 0.3 * arr(rng, 6), "var": 1.0 + np.abs(arr(rng, 6))}}}
    model = port_from(L.bN(6), v)
    stats0 = v["batch_stats"]["BatchNorm_0"]
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.apply(v, x, use_running_average=True)), **TOL)
        model.train()
        got = model(torch.from_numpy(x)).numpy()
    want, updated = jm.apply(v, x, use_running_average=False, mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    new = updated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(model.running_mean.numpy(), np.asarray(new["mean"]), **TOL)
    n = x.shape[0] * x.shape[2]
    biased = (np.asarray(new["var"]) - 0.9 * stats0["var"]) / 0.1
    np.testing.assert_allclose(model.running_var.numpy(), 0.9 * stats0["var"] + 0.1 * biased * n / (n - 1), **TOL)
    assert int(model.num_batches_tracked) == 1


@pytest.mark.parametrize("name", ["gLN", "cLN", "LN", "bN", "GlobalLN", "ChannelLN", "CumulateLN"])
def test_get_norm_takes_the_jax_registrys_names(name):
    assert get_norm(name).__name__ == jax_get_norm(name).__name__


@pytest.mark.parametrize("name", ["linear", "relu", "leaky_relu", "sigmoid", "softmax", "tanh", "gelu", "prelu"])
def test_get_activation_matches_the_jax_registry(name):
    x = arr(np.random.default_rng(6), 3, 7) * 2.0
    got, want = get_activation(name), jax_get_activation(name)
    if name == "prelu":
        assert got is L.PReLU and want is J.PReLU
        return
    np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(), np.asarray(want(jnp.asarray(x))), **TOL)


def test_registries_pass_classes_through_and_refuse_unknown_names():
    assert get_norm(None) is None and get_activation(None) is None
    assert get_norm(L.gLN) is L.gLN and get_activation(torch.tanh) is torch.tanh
    for getter in (get_norm, get_activation, jax_get_norm, jax_get_activation):
        with pytest.raises(ValueError, match="Could not interpret"):
            getter("nope")
        with pytest.raises(ValueError, match="Could not interpret"):
            getter(3)


def test_make_enc_dec_pairs_a_filterbank_and_refuses_unknown_names():
    enc, dec = L.make_enc_dec("free", 16, 8)
    assert isinstance(enc.fb, L.FreeFB) and dec.fb is enc.fb and enc.fb.stride == 4
    enc, dec = L.make_enc_dec(L.Filterbank, 16, 8, stride=2)
    assert type(enc.fb) is L.Filterbank and enc.fb.stride == 2
    x = torch.randn(2, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert dec(enc(x)).shape == (2, 64)
    for make in (L.make_enc_dec, J.make_enc_dec):
        with pytest.raises(ValueError, match="Unknown filterbank"):
            make("stft", 16, 8)


def test_wav_file_separate_matches_the_jax_package(tmp_path):
    """A 0.3 s wav through a small ConvTasNet in both packages on the same
    weights: one ``<prefix>_s{i}.wav`` a speaker, at the model's rate, the
    samples the JAX package's within one PCM16 step."""
    jm, params, model = make_pair(seed=11)
    wav = 0.3 * np.random.default_rng(12).standard_normal(2400).astype(np.float32)
    path = str(tmp_path / "mix.wav")
    write_wav(path, wav, 8000)
    got = wav_file_separate(model, path, str(tmp_path / "port"))
    want = jax_wav_file_separate(jm, params, path, str(tmp_path / "jax"), sample_rate=8000)
    assert got == [str(tmp_path / f"port_s{i}.wav") for i in (1, 2)] and len(want) == 2
    for g, w in zip(got, want):
        a, b = read_wav(g), read_wav(w)
        assert a.shape == b.shape == wav.shape
        assert np.abs(a - b).max() <= 1.0 / 32767 + 1e-7
    with pytest.raises(NotImplementedError):
        Separator().forward_wav(wav)


# the blocks that reach a kernel, at the widths the kernels take, and the
# kernels their bf16 form launches there (``ops/rnn.py::kernel_choice``:
# K6 at narrow inputs or short sequences, K5 at 64 or more steps of width
# 128 over 16 or fewer sequences)
KERNEL_CASES = {
    "SingleRNN": (lambda: L.SingleRNN(16, 32), (3, 9, 16), {"K6": 1}),
    "SingleRNN bidirectional": (lambda: L.SingleRNN(16, 32, bidirectional=True), (3, 9, 16), {"K6": 1}),
    "SingleRNN at K5's shapes": (lambda: L.SingleRNN(128, 32), (3, 64, 128), {"K5": 1}),
    "SingleRNN bidirectional at K5's shapes": (lambda: L.SingleRNN(128, 32, bidirectional=True), (3, 64, 128),
                                               {"K5": 1}),
    "LSTMBlockTF": (lambda: L.LSTMBlockTF(16, 32), (3, 9, 16), {"K6": 1}),
    "TransformerBlockTF": (lambda: L.TransformerBlockTF(32, 4, 64), (2, 11, 32), {"K4": 1}),
    "DPRNNBlock one-direction columns": (lambda: L.DPRNNBlock(16, 32, bidirectional=False), (2, 16, 6, 5),
                                         {"K6": 2}),
    # rows: 4 steps over 64 sequences (K6); one-direction columns: 64 steps over 4 sequences (K5)
    "DPRNNBlock one-direction columns at K5's shapes": (lambda: L.DPRNNBlock(128, 32, bidirectional=False),
                                                        (1, 128, 4, 64), {"K5": 1, "K6": 1}),
    "DPRNN": (lambda: L.DPRNN(16, 32, n_repeats=2), (25, 16, 6, 5), {"K6": 4}),  # rows 125, columns 150
    "DPRNNLinear": (lambda: L.DPRNNLinear(16, 32, 5), (2, 16, 6, 5), {"K6": 1}),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_bf16_kernel_form_meets_the_rule_against_f32(case, monkeypatch):
    """The block in bf16 through the kernels' form (``kernel_input`` forced,
    the kernels' plain versions counting their calls) against the f32
    block: its max error within 1.5x the plain bf16 block's + 1e-3 (the
    rule of PERF.md section 2), and the kernels it takes counted."""
    ctor, shape, launches = KERNEL_CASES[case]
    torch.manual_seed(len(case))
    model = ctor().eval()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(7))
    bf = ctor().eval()
    bf.load_state_dict(model.state_dict())
    bf = bf.to(torch.bfloat16)
    with torch.no_grad():
        ref = model(x)
        plain = bf(x.to(torch.bfloat16)).float()
    got, counts = count_kernel_launches(monkeypatch, lambda: bf(x.to(torch.bfloat16)).float())
    assert counts == {"K4": 0, "K5": 0, "K6": 0, **launches}
    e_k, e_p = float((got - ref).abs().max()), float((plain - ref).abs().max())
    assert torch.isfinite(got).all() and e_k <= 1.5 * e_p + 1e-3, (e_k, e_p)
    with kernels.plain_versions():  # the block's own dispatch inside the plain versions' block
        monkeypatch.setattr(kernels, "kernel_input", lambda t: True)
        with torch.no_grad():
            again = bf(x.to(torch.bfloat16)).float()
    assert torch.equal(again, got)


@pytest.mark.parametrize("shape", [(2, 6, 9), (2, 6, 4, 3)], ids=["3-D", "4-D"])
def test_channel_layer_norm_matches_jax(shape):
    """``ops.norms.ChannelLayerNorm`` (the JAX package's alias of
    ``FrameLayerNorm``) against the JAX module on the same input and
    affine: within 1e-5; ``ops`` re-exports it with the JAX package's 20
    names."""
    from audio_only_speech_separation_tpu.ops import __all__ as jax_ops_all
    from audio_only_speech_separation_tpu.ops.norms import ChannelLayerNorm as JChannelLayerNorm
    from audio_only_speech_separation_tpu_torch import ops
    from audio_only_speech_separation_tpu_torch.ops.norms import ChannelLayerNorm, FrameLayerNorm

    assert ChannelLayerNorm is FrameLayerNorm and ops.ChannelLayerNorm is ChannelLayerNorm
    assert ops.__all__ == list(jax_ops_all) and all(hasattr(ops, n) for n in ops.__all__)
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    jm = JChannelLayerNorm(shape[1])
    params = draw_tree(jm.init(jax.random.PRNGKey(0), x), np.random.default_rng(3))
    want = np.asarray(jm.apply(params, x))
    m = ChannelLayerNorm(shape[1])
    m.load_state_dict({"weight": torch.from_numpy(np.asarray(params["params"]["gamma"])),
                       "bias": torch.from_numpy(np.asarray(params["params"]["beta"]))})
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(), want, rtol=1e-5, atol=1e-5)

