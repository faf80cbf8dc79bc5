"""The kernels' envelopes and the dispatch that follows them, on the CPU
against the JAX package.

Each kernel has one envelope predicate, used both by its wrapper's check
and by the dispatch: ``block_kernel_ok`` (K1/K2), ``lstm_kernel_ok`` (K5,
K6) and ``attention_kernel_ok`` (K4).  Outside it the dispatch takes the
plain path before any wrapper is called.  The LSTM and attention dispatch
is driven here as if the input were bf16 on the card
(``kernels.kernel_input`` forced true), with stand-ins for the kernel
wrappers that raise: inside the envelope they are reached, outside it the
output is the plain path's, within 1e-5 of the JAX package in f32.
"""

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.ops.attention import MultiheadAttention as JMHA
from audio_only_speech_separation_tpu.ops.pallas.lstm import _xla_resident_ref
from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import (
    fused_forward_eligible,
    make_kernel_train_apply,
)
from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
from audio_only_speech_separation_tpu_torch.ops.attention import MultiheadAttention
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import attention_kernel_ok
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import block_kernel_ok
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import lstm_kernel_ok
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch

torch.set_num_threads(2)


@pytest.mark.parametrize("predicate,width,inside", [
    (block_kernel_ok, 128, True), (block_kernel_ok, 640, True), (block_kernel_ok, 768, False),
    (block_kernel_ok, 320, False),
    (lstm_kernel_ok, 16, True), (lstm_kernel_ok, 256, True), (lstm_kernel_ok, 8, False),
    (lstm_kernel_ok, 272, False), (lstm_kernel_ok, 40, False),
    (attention_kernel_ok, 8, True), (attention_kernel_ok, 256, True), (attention_kernel_ok, 4, False),
    (attention_kernel_ok, 264, False), (attention_kernel_ok, 20, False),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_envelope_predicates_at_their_edges(predicate, width, inside):
    assert predicate(width) is inside


def test_envelope_predicates_other_conditions():
    """K1/K2 also need a 128-channel bottleneck and 16-sample filters; K6
    an input width that is a multiple of 16."""
    assert not block_kernel_ok(512, C=64) and not block_kernel_ok(512, win=32)
    assert lstm_kernel_ok(128, Din=64) and not lstm_kernel_ok(128, Din=24)


def _convtasnet(H):
    return ConvTasNet(N=H, L=16, B=128, H=H, P=3, X=1, R=1, num_spks=2, sample_rate=8000)


def test_choose_dispatch_serves_a_convtasnet_outside_the_envelope_eagerly():
    """N = H = 768 is past K1's H <= 640: served by the module cast to
    bf16 ("kernels", which has no kernel for it) on the card, and by the
    module in its own dtype ("eager") without bf16, where N = H = 640
    takes the fused kernel; the trainer's kernel path raises before K2
    runs."""
    wide, edge = _convtasnet(768), _convtasnet(640)
    assert not fused_forward_eligible(wide, "cuda") and fused_forward_eligible(edge, "cuda")
    assert choose_dispatch(wide, True, "cuda") == "kernels"
    assert choose_dispatch(wide, False, "cuda") == "eager"
    assert choose_dispatch(edge, True, "cuda") == "fused"
    with pytest.raises(ValueError, match="H <= 640"):
        make_kernel_train_apply(wide)


def _raise(*args, **kwargs):
    raise AssertionError("a kernel stand-in was called")


@pytest.fixture
def as_on_card(monkeypatch):
    """Dispatch treats every tensor as a kernel input; the kernel wrappers
    are stand-ins that raise."""
    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    for module, name in ((port_rnn, "fused_bilstm"), (port_rnn, "resident_bilstm"),
                         (port_attention, "fused_attention_bdt"), (port_attention, "fused_attention_packed")):
        monkeypatch.setattr(module, name, _raise)


# (B, Din, H): inside the envelope through K5 (B <= 128) and K6 (B > 128),
# and outside it at H 8, 24 and 272
LSTM_DISPATCH = [(3, 16, 16, True), (130, 16, 16, True), (3, 16, 8, False), (130, 16, 24, False),
                 (2, 8, 272, False)]


@pytest.mark.parametrize("B,Din,H,inside", LSTM_DISPATCH)
def test_lstm_dispatch_takes_the_plain_path_outside_the_envelope(as_on_card, B, Din, H, inside):
    rng = np.random.default_rng(B + Din + H)
    x = (rng.standard_normal((B, 5, Din)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((2, Din, 4 * H)) * 0.08).astype(np.float32)
    whh = (rng.standard_normal((2, H, 4 * H)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((2, 4 * H)) * 0.05).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, wih, whh, bias)]
    if inside:
        with pytest.raises(AssertionError, match="stand-in"):
            port_rnn.lstm_hidden(*args)
        return
    got = port_rnn.lstm_hidden(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(_xla_resident_ref(x, wih, whh, bias)),
                               rtol=1e-5, atol=1e-5)


# (E, heads): dh 16 inside; dh 4 and 264 outside
MHA_DISPATCH = [(32, 2, True), (8, 2, False), (264, 1, False)]


@pytest.mark.parametrize("E,heads,inside", MHA_DISPATCH)
def test_attention_dispatch_takes_the_plain_path_outside_the_envelope(as_on_card, E, heads, inside):
    rng = np.random.default_rng(E + heads)
    jm = JMHA(E, heads)
    p = {"in_proj_weight": rng.standard_normal((3 * E, E)) / np.sqrt(E),
         "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
         "out_proj": {"kernel": rng.standard_normal((E, E)) / np.sqrt(E),
                      "bias": 0.1 * rng.standard_normal(E)}}
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), {"params": p})
    m = MultiheadAttention(E, heads)
    m.load_state_dict({"in_proj_weight": torch.from_numpy(p["params"]["in_proj_weight"]),
                       "in_proj_bias": torch.from_numpy(p["params"]["in_proj_bias"]),
                       "out_proj.weight": torch.from_numpy(p["params"]["out_proj"]["kernel"].T.copy()),
                       "out_proj.bias": torch.from_numpy(p["params"]["out_proj"]["bias"])})
    x = rng.standard_normal((2, 7, E)).astype(np.float32)
    with torch.no_grad():
        if inside:
            with pytest.raises(AssertionError, match="stand-in"):
                m.eval()(torch.from_numpy(x))
            return
        got = m.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(p, x)), rtol=1e-5, atol=1e-5)
