"""The port's STFT library (``layers/stft_lib.py``) and ``ops/stft.py::
stft_matmul`` against the JAX package's on the CPU: the numpy factories
(windows, DFT kernels, mel and speed-perturbation filters) within 1e-6
elementwise, the transforms in every mode within 1e-5 of the output's
largest magnitude (f32 sums of a frame's products, in another order), the
round trip, and ``stft_matmul`` against JAX's and the port's own
``stft``.  An inverse without centring is compared where the overlapped
squared window covers the signal: at the two ends it falls towards 0 and
divides rounding up."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_only_speech_separation_tpu.layers.stft_lib as J
from audio_only_speech_separation_tpu.ops.stft import hann_window as jax_hann_window
from audio_only_speech_separation_tpu.ops.stft import stft_matmul as jax_stft_matmul
from audio_only_speech_separation_tpu_torch.layers import stft_lib as L
from audio_only_speech_separation_tpu_torch.ops.stft import hann_window, stft, stft_matmul

torch.set_num_threads(2)
TOL = 1e-5  # of the output's largest magnitude
FACTORY = dict(rtol=1e-6, atol=1e-6)
WINDOWS = ["rect", "hann", "sqrthann", "hamm", "blackman", "bartlett"]


def wave(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    """Elementwise within ``tol`` (a dict of rtol/atol), or within ``tol``
    (a number) of want's largest magnitude."""
    got, want = (got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)), np.asarray(want)
    if isinstance(tol, dict):
        np.testing.assert_allclose(got, want, **tol)
        return
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("wnd", WINDOWS)
@pytest.mark.parametrize("frame_len", [256, 400])
def test_init_window(wnd, frame_len):
    close(L.init_window(wnd, frame_len), J.init_window(wnd, frame_len), FACTORY)


@pytest.mark.parametrize("mode", ["librosa", "kaldi"])
@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("frame_len, pow2", [(256, True), (400, True), (400, False)])
def test_init_kernel(mode, normalized, inverse, frame_len, pow2):
    win = J.init_window("hann", frame_len)
    kw = dict(round_pow_of_two=pow2, normalized=normalized, inverse=inverse, mode=mode)
    for got, want in zip(L.init_kernel(frame_len, 128, win, **kw), J.init_kernel(frame_len, 128, win, **kw)):
        close(got, want, FACTORY)


@pytest.mark.parametrize("norm", [False, True], ids=["htk", "slaney"])
@pytest.mark.parametrize("kw", [dict(), dict(fmin=80.0, fmax=7600.0), dict(fmax=-400.0, num_mels=40),
                                dict(num_bins=257, sr=8000)])
def test_mel_filter(norm, kw):
    close(L.mel_filter(400, norm=norm, **kw), J.mel_filter(400, norm=norm, **kw), FACTORY)


@pytest.mark.parametrize("rates", [(16000, 15200), (8000, 8800), (16000, 17600)])
def test_speed_perturb_filter(rates):
    close(L.speed_perturb_filter(*rates), J.speed_perturb_filter(*rates), FACTORY)


def test_factories_refuse_what_the_jax_ones_refuse():
    for lib in (L, J):
        with pytest.raises(RuntimeError, match="Unknown window"):
            lib.init_window("gauss", 64)
        with pytest.raises(ValueError, match="Unsupported mode"):
            lib.init_kernel(64, 16, np.ones(64, np.float32), mode="torch")
        with pytest.raises(ValueError, match="two distinct rates"):
            lib.speed_perturb_filter(8000, 8000)
        with pytest.raises(ValueError, match="integer-ratio"):
            lib.speed_perturb_filter(8000, 16000)
        with pytest.raises(ValueError, match="Unknown op"):
            lib.splice_feature(np.zeros((2, 5, 3), np.float32) if lib is J else torch.zeros(2, 5, 3), op="sum")


@pytest.mark.parametrize("op", ["cat", "stack"])
@pytest.mark.parametrize("ctx", [(1, 1), (2, 0), (0, 0), (3, 2)])
def test_splice_feature(op, ctx):
    feats = wave(1, 2, 7, 5)
    close(L.splice_feature(torch.from_numpy(feats), *ctx, op=op), J.splice_feature(jnp.asarray(feats), *ctx, op=op))


# (mode, keyword arguments of forward_stft / inverse_stft)
TRANSFORMS = {
    "librosa": ("librosa", dict()),
    "librosa centred": ("librosa", dict(center=True)),
    "librosa two-sided": ("librosa", dict(onesided=False)),
    "librosa normalized hann": ("librosa", dict(normalized=True, window="hann")),
    "librosa 400 not padded": ("librosa", dict(round_pow_of_two=False)),
    "librosa 400 padded": ("librosa", dict(frame_len=400)),
    "kaldi": ("kaldi", dict(frame_len=400, window="hamm")),
    "kaldi pre-emphasis": ("kaldi", dict(frame_len=400, pre_emphasis=0.97)),
    "torch": ("torch", dict(window="hann")),
    "torch centred normalized": ("torch", dict(window="hann", center=True, normalized=True)),
    "torch two-sided": ("torch", dict(onesided=False)),
    "torch 400 padded": ("torch", dict(frame_len=400, window="hann", center=True)),
}


def transform_args(case):
    mode, kw = TRANSFORMS[case]
    kw = dict(kw)
    return kw.pop("frame_len", 256), dict(kw, mode=mode)


@pytest.mark.parametrize("case", list(TRANSFORMS))
@pytest.mark.parametrize("polar", [False, True])
@pytest.mark.parametrize("channels", [False, True], ids=["mono", "multichannel"])
def test_forward_stft(case, polar, channels):
    frame_len, kw = transform_args(case)
    x = wave(2, 2, 3, 2000) if channels else wave(2, 2, 2000)
    got = L.forward_stft(torch.from_numpy(x), frame_len, 128, return_polar=polar, **kw)
    want = J.forward_stft(jnp.asarray(x), frame_len, 128, return_polar=polar, **kw)
    if polar:  # the phase of a near-zero bin is ill-conditioned: compare the magnitudes, then the unit phasors
        close(got[..., 0], want[..., 0])
        close(torch.cos(got[..., 1]), jnp.cos(want[..., 1]), 1e-4)
    else:
        close(got, want)


@pytest.mark.parametrize("case", [c for c in TRANSFORMS if "pre-emphasis" not in c])
@pytest.mark.parametrize("polar", [False, True])
def test_inverse_stft_and_the_round_trip(case, polar):
    """The inverse against JAX's on JAX's own transform, and the port's
    round trip giving the wave back inside the fully covered span."""
    frame_len, kw = transform_args(case)
    x = wave(3, 2, 2048)
    spec = np.array(J.forward_stft(jnp.asarray(x), frame_len, 128, return_polar=polar, **kw))
    got = L.inverse_stft(torch.from_numpy(spec), frame_len, 128, return_polar=polar, **kw)
    want = np.asarray(J.inverse_stft(jnp.asarray(spec), frame_len, 128, return_polar=polar, **kw))
    n = got.shape[-1]
    edge = 0 if kw.get("center") else 512
    close(got[:, edge:n - edge], want[:, edge:n - edge])
    back = L.inverse_stft(L.forward_stft(torch.from_numpy(x), frame_len, 128, return_polar=polar, **kw),
                          frame_len, 128, return_polar=polar, **kw)
    close(back[:, edge:n - edge], x[:, edge:n - edge], 1e-4)


@pytest.mark.parametrize("case", ["librosa centred", "kaldi pre-emphasis", "torch centred normalized",
                                  "torch two-sided"])
def test_layer_classes(case):
    """``STFT``/``iSTFT`` against the JAX classes: the transform, its
    inverse, ``num_frames`` and the repr."""
    frame_len, kw = transform_args(case)
    kw.pop("mode")
    mode = TRANSFORMS[case][0]
    x = wave(4, 2, 1999)
    fwd, jfwd = L.STFT(frame_len, 128, mode=mode, **kw), J.STFT(frame_len, 128, mode=mode, **kw)
    spec = fwd(torch.from_numpy(x))
    close(spec, jfwd(jnp.asarray(x)))
    kw.pop("pre_emphasis", None)
    inv, jinv = L.iSTFT(frame_len, 128, mode=mode, **kw), J.iSTFT(frame_len, 128, mode=mode, **kw)
    got, want = inv(spec), np.asarray(jinv(jnp.asarray(spec.numpy())))
    edge = 0 if fwd.center else 512
    close(got[:, edge:got.shape[-1] - edge], want[:, edge:want.shape[-1] - edge])
    lengths = [1999, 4000]
    assert list(fwd.num_frames(lengths)) == list(jfwd.num_frames(lengths))
    assert fwd.num_frames(1999) == spec.shape[-2]
    assert repr(fwd) == repr(jfwd) and repr(inv) == repr(jinv)
    with pytest.raises(ValueError, match="must exceed"):
        fwd.num_frames(10)


@pytest.mark.parametrize("n_fft, hop, center", [(256, 64, True), (256, 100, True), (200, 80, False)])
def test_stft_matmul_matches_jax_and_the_ports_stft(n_fft, hop, center):
    x = wave(5, 3, 4000)
    re, im = stft_matmul(torch.from_numpy(x), n_fft, hop, hann_window(n_fft), center=center)
    jre, jim = jax_stft_matmul(jnp.asarray(x), n_fft, hop, jax_hann_window(n_fft), center=center)
    close(re, jre)
    close(im, jim)
    spec = stft(torch.from_numpy(x), n_fft, hop, hann_window(n_fft), center=center)
    assert re.shape == spec.shape == (3, n_fft // 2 + 1, spec.shape[-1]) and re.dtype == torch.float32
    close(re, spec.real.numpy())
    close(im, spec.imag.numpy())
