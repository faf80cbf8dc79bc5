"""The port's ops against their JAX counterparts, in float32.

Each case draws its inputs and weights with numpy from a seed and sends
them through both packages.  Tolerance 1e-5 absolute (2e-5 for the norms,
whose statistics sum over a whole sample): float32 rounding in a different
summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.ops import activations as jact
from audio_only_speech_separation_tpu.ops import conv as jconv
from audio_only_speech_separation_tpu.ops import norms as jnorms
from audio_only_speech_separation_tpu_torch.ops import activations, conv, norms

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("T,win,stride", [(160, 16, 4), (203, 16, 4), (100, 10, 4)])
def test_frame_signal_and_overlap_add(T, win, stride):
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T)).astype(np.float32)
    want = np.asarray(jconv.frame_signal(jnp.asarray(x), win, stride))
    got = conv.frame_signal(_t(x), win, stride).numpy()
    np.testing.assert_array_equal(got, want)  # framing copies, exactly
    frames = rng.standard_normal(want.shape).astype(np.float32)
    want_oa = np.asarray(jconv.overlap_add(jnp.asarray(frames), stride))
    got_oa = conv.overlap_add(_t(frames), stride).numpy()
    np.testing.assert_allclose(got_oa, want_oa, atol=1e-5)


def test_encoder_and_decoder():
    rng = np.random.default_rng(1)
    N, win, stride = 32, 16, 4
    x = rng.standard_normal((2, 200)).astype(np.float32)
    we = rng.standard_normal((win, N)).astype(np.float32)  # JAX layout [win, N]
    want = np.asarray(jconv.ConvEncoder(N, win, stride).apply({"params": {"kernel": we}}, x))
    enc = conv.ConvEncoder(N, win, stride)
    enc.load_state_dict({"_filters": _t(we.T[:, None, :])})
    with torch.no_grad():
        got = enc(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

    wd = rng.standard_normal((N, win)).astype(np.float32)  # JAX layout [N, win]
    z = rng.standard_normal(want.shape).astype(np.float32)
    want_d = np.asarray(jconv.ConvDecoder(N, win, stride).apply({"params": {"kernel": wd}}, z))
    dec = conv.ConvDecoder(N, win, stride)
    dec.load_state_dict({"_filters": _t(wd[:, None, :])})
    with torch.no_grad():
        got_d = dec(_t(z)).numpy()
    np.testing.assert_allclose(got_d, want_d, atol=1e-5)


@pytest.mark.parametrize("kind", ["gLN", "cLN"])
def test_norms(kind):
    rng = np.random.default_rng(2)
    C = 24
    x = rng.normal(1.5, 2.0, size=(3, C, 50)).astype(np.float32)
    g = (1 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    b = (0.3 * rng.standard_normal(C)).astype(np.float32)
    if kind == "gLN":
        jm, p = jnorms.GlobalLayerNorm(C), {"gamma": g, "beta": b}
        tm = norms.GlobalLayerNorm(C)
    else:
        jm, p = jnorms.CumulativeLayerNorm(C), {"gain": g[None, :, None], "bias": b[None, :, None]}
        tm = norms.CumulativeLayerNorm(C)
    want = np.asarray(jm.apply({"params": p}, x))
    tm.load_state_dict({"weight": _t(g), "bias": _t(b)})
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("alpha", [0.25, 1.7])
def test_prelu(alpha):
    x = np.random.default_rng(3).standard_normal((2, 8, 30)).astype(np.float32)
    want = np.asarray(jact.PReLU().apply({"params": {"alpha": np.array([alpha], np.float32)}}, x))
    m = activations.PReLU()
    m.load_state_dict({"weight": torch.tensor([alpha])})
    with torch.no_grad():
        got = m(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("dilation", [1, 4])
def test_dilated_depthwise_conv(dilation):
    """The port's depthwise conv is nn.Conv1d(groups=C) with the JAX
    package's padding (dilation * (k-1) // 2)."""
    rng = np.random.default_rng(4)
    C, k = 16, 3
    pad = dilation * (k - 1) // 2
    x = rng.standard_normal((2, C, 40)).astype(np.float32)
    kern = rng.standard_normal((k, 1, C)).astype(np.float32)  # JAX [k, 1, C]
    bias = rng.standard_normal(C).astype(np.float32)
    jm = jconv.Conv1d(C, kernel_size=k, dilation=dilation, padding=pad, groups=C)
    want = np.asarray(jm.apply({"params": {"Conv_0": {"kernel": kern, "bias": bias}}}, x))
    tm = torch.nn.Conv1d(C, C, k, dilation=dilation, padding=pad, groups=C)
    tm.load_state_dict({"weight": _t(np.transpose(kern, (2, 1, 0))), "bias": _t(bias)})
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
