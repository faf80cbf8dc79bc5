"""The port's BSRNN against the JAX package on the CPU, in float32: the band
partition, the STFT pair (also against ``torch.stft``/``torch.istft``),
the whole model at 8 and 16 kHz on shared weights, the weight converter
both ways, the LSTM dispatch of a bf16 model with the card forced, and a
bf16 copy of the module whose STFT stays float32."""

import copy
import importlib

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import BSRNN as JBSRNN
from audio_only_speech_separation_tpu.models.bsrnn import compute_band_widths as jax_band_widths
from audio_only_speech_separation_tpu.utils.torch_import import convert
from audio_only_speech_separation_tpu_torch.models import BSRNN, from_pretrain, serialize
from audio_only_speech_separation_tpu_torch.models import bsrnn as port_bsrnn
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
    bilstm_reference,
    resident_bilstm_reference,
)
from audio_only_speech_separation_tpu_torch.ops.stft import hann_window, istft, stft
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch
from audio_only_speech_separation_tpu_torch.utils.jax_import import bsrnn_from_jax
from torch_port_helpers import assert_close, assert_same_tree, perturbed, state_numpy

torch.set_num_threads(2)
jax_stft = importlib.import_module("audio_only_speech_separation_tpu.ops.stft")

# feature_dim 16 (BiLSTM H 32), 2 repeats, win 256 / hop 64
SMALL = dict(win=256, stride=64, feature_dim=16, num_spks=2, num_layer=1, num_repeat=2)


def _port_model(seed, **overrides):
    cfg = dict(SMALL, **overrides)
    return perturbed(BSRNN(**cfg, generator=torch.Generator().manual_seed(seed)), seed)


def _jax_params(model):
    return convert("BSRNN", state_numpy(model), nband=model.nband, num_repeat=model.num_repeat,
                   num_layer=model.num_layer, bi_comm=model.bi_comm)


@pytest.mark.parametrize("sample_rate", [8000, 16000, 44100])
@pytest.mark.parametrize("enc_dim", [129, 1025])
def test_band_widths_match_jax(sample_rate, enc_dim):
    got = port_bsrnn.compute_band_widths(sample_rate, enc_dim)
    assert got == jax_band_widths(sample_rate, enc_dim) and sum(got) == enc_dim
    if (sample_rate, enc_dim) == (8000, 129):
        assert got == [3, 3, 8, 8, 8, 16, 16, 67]


def test_hann_window_matches_torch_and_jax():
    got = hann_window(256)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.hann_window(256, periodic=True, dtype=torch.float64).float())
    assert np.array_equal(got.numpy(), np.asarray(jax_stft.hann_window(256)))


@pytest.mark.parametrize("n_fft,hop,T", [(256, 64, 3000), (256, 64, 4001), (64, 16, 777)])
def test_stft_pair_matches_jax_and_torch(n_fft, hop, T):
    """The spectrum against the JAX package's and ``torch.stft``'s; the
    inverse against the JAX package's and ``torch.istft``'s, cropped to
    ``length``, which gives the signal back."""
    x = np.random.default_rng(T).standard_normal((2, T)).astype(np.float32)
    w = hann_window(n_fft)
    spec = stft(torch.from_numpy(x), n_fft, hop, w)
    want = np.asarray(jax_stft.stft(x, n_fft, hop, np.asarray(w)))
    lib = torch.stft(torch.from_numpy(x), n_fft, hop, window=w, center=True, pad_mode="reflect",
                     return_complex=True)
    assert spec.shape == lib.shape == want.shape
    for ref in (want, lib.numpy()):
        assert np.abs(spec.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    back = istft(spec, n_fft, hop, w, length=T)
    for ref in (np.asarray(jax_stft.istft(spec.numpy(), n_fft, hop, np.asarray(w), length=T)),
                torch.istft(spec, n_fft, hop, window=w, center=True, length=T).numpy(), x):
        assert_close(back.numpy(), ref, 1e-5)


@pytest.mark.parametrize("sample_rate,overrides,shape", [
    (8000, {}, (2, 3000)),
    (16000, {}, (1, 2500)),
    (8000, dict(context=1, bi_comm=False), (2, 2100)),
], ids=["8k", "16k", "context_unidirectional_comm"])
def test_bsrnn_matches_jax(sample_rate, overrides, shape):
    """Random port weights converted with the JAX package's converter: the
    same output within 1e-4 of its scale (8 bands at 8 kHz, 16 at 16 kHz;
    a context frame and a one-way band-comm RNN)."""
    model = _port_model(1, sample_rate=sample_rate, **overrides)
    assert model.nband == len(jax_band_widths(sample_rate, 129))
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = jax.jit(JBSRNN(**SMALL, sample_rate=sample_rate, **overrides).apply)(_jax_params(model), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_close(got.numpy(), want)


def test_bsrnn_one_d_input():
    """A 1-D wave comes back [n_src, T], the batch-of-one output."""
    model = _port_model(1, sample_rate=8000)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(1700).astype(np.float32))
    with torch.no_grad():
        got, want = model(x), model(x[None])[0]
    assert got.shape == (2, 1700) and torch.equal(got, want)


def test_bsrnn_from_jax_round_trip():
    """A JAX parameter tree (another model's weights, through the JAX
    package's converter) gives the JAX output through the port, and
    converting the port's weights back gives the same tree; a checkpoint
    the port writes reloads with its own band partition."""
    jm = JBSRNN(**SMALL, sample_rate=8000)
    x = np.random.default_rng(3).standard_normal((2, 3000)).astype(np.float32)
    params = _jax_params(_port_model(4, sample_rate=8000))
    model = BSRNN(**SMALL, sample_rate=8000)
    sd = bsrnn_from_jax(params, model.nband, SMALL["num_repeat"], SMALL["num_layer"], True)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    with torch.no_grad():
        assert_close(model.eval()(torch.from_numpy(x)).numpy(), jax.jit(jm.apply)(params, x))
    assert_same_tree(params, _jax_params(model))
    conf = serialize(model)
    assert conf["model_args"]["sample_rate"] == 8000
    again = from_pretrain(conf, device="cpu")
    assert again.band_width == model.band_width == [3, 3, 8, 8, 8, 16, 16, 67]


@pytest.fixture
def lstm_calls(monkeypatch):
    """Dispatch treats every tensor as a kernel input; K5 and K6 are
    stand-ins that record their shapes and return the plain result."""
    calls = {"K5": [], "K6": []}

    def k5(xw, w_hh):
        calls["K5"].append(tuple(xw.shape))
        return bilstm_reference(xw, w_hh)

    def k6(x, w_ih, w_hh, bias):
        calls["K6"].append(tuple(x.shape))
        return resident_bilstm_reference(x, w_ih, w_hh, bias)

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_rnn, "fused_bilstm", k5)
    monkeypatch.setattr(port_rnn, "resident_bilstm", k6)
    return calls


@pytest.mark.parametrize("feature_dim", [16, 128])
def test_bf16_bsrnn_lstm_dispatch(lstm_calls, feature_dim):
    """With the card forced, a bf16 BSRNN sends each band-comm RNN (B*T =
    252 sequences of 8 bands) to K6, and each band RNN (B*nband = 16
    sequences of 126 frames) to K6 at width 16 and to K5 at width 128
    (``ops/rnn.py::kernel_choice``): one launch each a repeat; the output
    is finite and near the float32 module's."""
    model = _port_model(5, sample_rate=8000, feature_dim=feature_dim)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 8000)).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        lstm_calls["K5"].clear(), lstm_calls["K6"].clear()
        out = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    band, comm = (16, 126, feature_dim), (252, 8, feature_dim)
    if feature_dim == 128:
        assert lstm_calls["K5"] == [(126, 2, 16, 4 * 2 * feature_dim)] * 2
        assert lstm_calls["K6"] == [comm] * 2
    else:
        assert lstm_calls["K5"] == [] and lstm_calls["K6"] == [band, comm] * 2
    assert float((out.float() - ref).norm() / ref.norm()) < 0.1


def test_bf16_copy_keeps_the_stft_float32(monkeypatch):
    """``serve``'s "kernels" dispatch casts a copy of the module to bf16:
    BSRNN holds no buffer that the cast could turn, builds its window in
    float32 and runs both transforms in float32; the body runs bf16."""
    model = _port_model(7, sample_rate=8000)
    assert choose_dispatch(model, True, "cuda") == "kernels"
    assert choose_dispatch(model, True, "cpu") == "eager"
    assert list(model.buffers()) == []
    seen = []

    def spy(fn):
        def wrapped(spec_or_x, n_fft, hop, window, **kw):
            seen.append((fn.__name__, spec_or_x.dtype, window.dtype))
            return fn(spec_or_x, n_fft, hop, window, **kw)
        return wrapped

    monkeypatch.setattr(port_bsrnn, "stft", spy(stft))
    monkeypatch.setattr(port_bsrnn, "istft", spy(istft))
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    with torch.no_grad():
        out = bf16(torch.zeros(1, 900).normal_(generator=torch.Generator().manual_seed(8)).bfloat16())
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert seen == [("stft", torch.float32, torch.float32), ("istft", torch.complex64, torch.float32)]
