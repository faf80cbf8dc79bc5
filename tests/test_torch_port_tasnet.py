"""The port's TasNet serving slice (DPRNN and DPTNet cores) against the JAX
package on the CPU, in float32: chunking, the channels-last gLN, the
attention and LSTM layers (plain form and the kernels' form, whose kernels
run as their plain versions here), the whole model, the weight converter,
and a JAX-written checkpoint served through the port."""

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import TasNet as JTasNet
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.ops.attention import MultiheadAttention as JMHA
from audio_only_speech_separation_tpu.ops.chunk import merge_feature as jmerge
from audio_only_speech_separation_tpu.ops.chunk import split_feature as jsplit
from audio_only_speech_separation_tpu.ops.norms import GlobalLayerNorm as JGLN
from audio_only_speech_separation_tpu.ops.rnn import LSTM as JLSTM
from audio_only_speech_separation_tpu.ops.rnn import MultiLayerLSTM as JMultiLayerLSTM
from audio_only_speech_separation_tpu.ops.rnn import bilstm_scan as jbilstm_scan
from audio_only_speech_separation_tpu.utils.torch_import import convert_tasnet
from audio_only_speech_separation_tpu_torch.models import TasNet, from_pretrain
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.attention import MultiheadAttention, mha_kernel_form
from audio_only_speech_separation_tpu_torch.ops.chunk import merge_feature, split_feature
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
    attention_bdt_reference,
    fused_attention_bdt,
    fused_attention_packed,
)
from audio_only_speech_separation_tpu_torch.ops.norms import GlobalLayerNorm
from audio_only_speech_separation_tpu_torch.ops.rnn import (
    LSTM,
    BiLSTM,
    MultiLayerLSTM,
    lstm_hidden_kernel_form,
    project,
)
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch, serve
from audio_only_speech_separation_tpu_torch.utils.jax_import import tasnet_from_jax

torch.set_num_threads(2)

SR = 8000
# small widths and depth: enc 32, hidden 32, two layers, 24-frame chunks
SMALL = dict(enc_dim=32, bn_dim=32, hidden_dim=32, win=16, layer=2, num_spk=2,
             block_size=24, sample_rate=SR)
MODELS = [("DPRNN", False), ("DPRNN", True), ("DPTNet", False), ("DPTNet", True)]


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def draw(params, rng):
    """Every leaf of a JAX parameter tree redrawn from ``rng``: norm scales
    and gate weights near 1, biases 0.1-scaled, PReLU slopes in (0.05, 1.5),
    matrices normal / sqrt(fan-in)."""
    def leaf(path, x):
        name, shape = str(path[-1].key), np.shape(x)
        if name == "alpha":
            return rng.uniform(0.05, 1.5, size=shape).astype(np.float32)
        if name in ("gamma", "scale") or (name == "weight" and len(shape) == 1):
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) == 1:
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


_PAIRS = {}


def tasnet_pair(module, unfold):
    """(JAX model, its params as numpy, port model with the same weights),
    made once per config."""
    if (module, unfold) not in _PAIRS:
        cfg = dict(SMALL, module=module, unfold=unfold)
        jm = JTasNet(**cfg)
        params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 400), np.float32))
        params = jax.tree_util.tree_map(np.asarray, draw(params, np.random.default_rng(3)))
        tm = TasNet(**cfg)
        sd = tasnet_from_jax(params, module, cfg["layer"], unfold)
        assert set(sd) == set(tm.state_dict())
        tm.load_state_dict({k: t(v) for k, v in sd.items()})
        _PAIRS[module, unfold] = (jm, params, tm.eval())
    return _PAIRS[module, unfold]


def _close(got, want, rel=1e-4):
    """float32 in both packages: max error <= rel of the output's scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("C,T,block", [(3, 500, 100), (2, 77, 24), (4, 2002, 100), (1, 10, 8)])
def test_split_and_merge_match_jax(C, T, block):
    """Chunking and overlap-add are layout moves: exactly the JAX result."""
    x = np.random.default_rng(T).standard_normal((2, C, T)).astype(np.float32)
    got, rest = split_feature(t(x), block)
    want, want_rest = jsplit(x, block)
    assert rest == want_rest and np.array_equal(got.numpy(), np.asarray(want))
    merged = merge_feature(got, rest)
    assert np.array_equal(merged.numpy(), np.asarray(jmerge(np.asarray(want), rest)))
    np.testing.assert_allclose(merged.numpy(), 2 * x, rtol=0, atol=1e-6)


def test_channels_last_gln_matches_jax():
    """The row and column norms: gLN over every axis but the batch, the
    affine on the last axis, eps 1e-8."""
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((2, 5, 7, 16))).astype(np.float32)
    g, b = 1 + 0.2 * rng.standard_normal(16), 0.1 * rng.standard_normal(16)
    jm = JGLN(16, eps=1e-8, channels_last=True)
    want = jm.apply({"params": {"gamma": g.astype(np.float32), "beta": b.astype(np.float32)}}, x)
    m = GlobalLayerNorm(16, 1e-8, channels_last=True)
    m.load_state_dict({"weight": t(g), "bias": t(b)})
    with torch.no_grad():
        np.testing.assert_allclose(m(t(x)).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _mha_pair(E, h, rng):
    jm = JMHA(E, h)
    p = {"in_proj_weight": rng.standard_normal((3 * E, E)) / np.sqrt(E),
         "in_proj_bias": 0.1 * rng.standard_normal(3 * E),
         "out_proj": {"kernel": rng.standard_normal((E, E)) / np.sqrt(E),
                      "bias": 0.1 * rng.standard_normal(E)}}
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), {"params": p})
    m = MultiheadAttention(E, h)
    m.load_state_dict({"in_proj_weight": t(p["params"]["in_proj_weight"]),
                       "in_proj_bias": t(p["params"]["in_proj_bias"]),
                       "out_proj.weight": t(p["params"]["out_proj"]["kernel"].T),
                       "out_proj.bias": t(p["params"]["out_proj"]["bias"])})
    return jm, p, m.eval()


@pytest.mark.parametrize("T", [100, 42, 13])
def test_multihead_attention_matches_jax(T):
    """DPTNet's self-attention (E 64, 4 heads, dh 16) with the same weights:
    the plain form (what f32 and CPU tensors run) and the kernel form around
    ``fused_attention_packed`` (its plain version on the CPU), both within
    1e-5 of the JAX module."""
    rng = np.random.default_rng(T)
    jm, p, m = _mha_pair(64, 4, rng)
    x = rng.standard_normal((3, T, 64)).astype(np.float32)
    want = np.asarray(jm.apply(p, x))
    with torch.no_grad():
        np.testing.assert_allclose(m(t(x)).numpy(), want, rtol=1e-5, atol=1e-5)
        w = (m.in_proj_weight, m.in_proj_bias, m.out_proj.weight, m.out_proj.bias)
        got = mha_kernel_form(t(x), *w, 4, fused_attention_packed)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_multihead_attention_mask_and_cross_attention_match_jax():
    """The plain form with a key mask and with separate key/value inputs."""
    rng = np.random.default_rng(5)
    jm, p, m = _mha_pair(32, 4, rng)
    q = rng.standard_normal((2, 9, 32)).astype(np.float32)
    kv = rng.standard_normal((2, 11, 32)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 9, 11)) > 0.3
    mask[..., 0] = True
    want = np.asarray(jm.apply(p, q, kv, kv, mask=mask))
    with torch.no_grad():
        got = m(t(q), t(kv), t(kv), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _lstm_weights(rng, D, Din, H):
    s = 1 / np.sqrt(H)
    return ((rng.uniform(-s, s, (D, Din, 4 * H))).astype(np.float32),
            (rng.uniform(-s, s, (D, H, 4 * H))).astype(np.float32),
            (rng.uniform(-s, s, (D, 4 * H))).astype(np.float32))


@pytest.mark.parametrize("B,Din", [(5, 16), (130, 16), (130, 12)])
def test_bilstm_kernel_form_matches_jax(B, Din):
    """The dispatch glue of the kernel form, with K5 (projection as a
    matmul, then the recurrence) or K6 (B > 128 and Din % 16 == 0: the
    resident form) as their plain versions: the fused relu + projection
    output of a DPTNet feed-forward within 1e-5 of the JAX ``bilstm_scan``."""
    rng = np.random.default_rng(B + Din)
    w_ih, w_hh, bias = _lstm_weights(rng, 2, Din, 32)
    pw = (rng.standard_normal((64, 16)) / 8).astype(np.float32)
    pb = (0.1 * rng.standard_normal(16)).astype(np.float32)
    x = rng.standard_normal((B, 7, Din)).astype(np.float32)
    want = np.asarray(jbilstm_scan(x, w_ih, w_hh, bias, pw, pb, jax.nn.relu))
    with torch.no_grad():
        hs = lstm_hidden_kernel_form(t(x), t(w_ih), t(w_hh), t(bias))
        got = project(hs, t(pw), t(pb), torch.relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    concat = np.asarray(jbilstm_scan(x, w_ih, w_hh, bias))
    np.testing.assert_allclose(project(hs).numpy(), concat, rtol=1e-5, atol=1e-5)


def test_lstm_modules_match_jax():
    """``BiLSTM`` and the unidirectional ``LSTM`` modules with nn.LSTM-named
    parameters against the JAX modules (whose bias is the sum of the two)."""
    rng = np.random.default_rng(9)
    w_ih, w_hh, bias = _lstm_weights(rng, 2, 8, 16)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    m = BiLSTM(8, 16)
    sd = {}
    for d, s in enumerate(("", "_reverse")):
        sd |= {f"weight_ih_l0{s}": t(w_ih[d].T), f"weight_hh_l0{s}": t(w_hh[d].T),
               f"bias_ih_l0{s}": t(bias[d] - 0.5), f"bias_hh_l0{s}": t(np.full(64, 0.5))}
    m.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(m(t(x)).numpy(), np.asarray(jbilstm_scan(x, w_ih, w_hh, bias)),
                                   rtol=1e-5, atol=1e-5)
    u = LSTM(8, 16)
    u.load_state_dict({"weight_ih_l0": t(w_ih[0].T), "weight_hh_l0": t(w_hh[0].T),
                       "bias_ih_l0": t(bias[0]), "bias_hh_l0": t(np.zeros(64))})
    want = JLSTM(16).apply({"params": {"w_ih": w_ih[0], "w_hh": w_hh[0], "bias": bias[0]}}, x)
    with torch.no_grad():
        np.testing.assert_allclose(u(t(x)).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_multilayer_lstm_matches_jax(bidirectional):
    """Two stacked layers (``layers.{i}`` here, ``layer_{i}`` in JAX)."""
    rng = np.random.default_rng(11)
    jm = JMultiLayerLSTM(16, num_layers=2, bidirectional=bidirectional)
    x = rng.standard_normal((3, 6, 8)).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), x))
    m = MultiLayerLSTM(8, 16, num_layers=2, bidirectional=bidirectional)
    sd = {}
    for i in range(2):
        lp = p["params"][f"layer_{i}"]
        w_ih, w_hh, b = (np.asarray(lp[k]) for k in ("w_ih", "w_hh", "bias"))
        if not bidirectional:
            w_ih, w_hh, b = w_ih[None], w_hh[None], b[None]
        for d, s in zip(range(w_ih.shape[0]), ("", "_reverse")):
            sd |= {f"layers.{i}.weight_ih_l0{s}": t(w_ih[d].T), f"layers.{i}.weight_hh_l0{s}": t(w_hh[d].T),
                   f"layers.{i}.bias_ih_l0{s}": t(b[d]), f"layers.{i}.bias_hh_l0{s}": t(np.zeros_like(b[d]))}
    m.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(m(t(x)).numpy(), np.asarray(jm.apply(p, x)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("module,unfold", MODELS)
def test_tasnet_matches_jax(module, unfold):
    """The whole model, same weights, T = 4001 samples at 8 kHz: max error
    <= 1e-4 of the output's max, in float32."""
    jm, params, tm = tasnet_pair(module, unfold)
    x = np.random.default_rng(1).standard_normal((2, 4001)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("module,unfold", MODELS)
def test_tasnet_weights_round_trip(module, unfold):
    """convert_tasnet(tasnet_from_jax(p)) gives p back, leaf for leaf."""
    _, params, _ = tasnet_pair(module, unfold)
    sd = tasnet_from_jax(params, module, SMALL["layer"], unfold)
    back = convert_tasnet(sd, module=module, layer=SMALL["layer"], unfold=unfold)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path], np.float32), leaf), path


@pytest.mark.parametrize("module", ["DPRNN", "DPTNet"])
def test_jax_checkpoint_serves_through_the_port(tmp_path, module):
    """A TasNet checkpoint the JAX package wrote loads through
    ``from_pretrain`` and serves through ``serve`` on the CPU (the eager
    path), each request against the JAX model on serve's padded batches."""
    jm, params, _ = tasnet_pair(module, True)
    ckpt = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), ckpt)
    model = from_pretrain(ckpt, device="cpu").eval()
    assert isinstance(model, TasNet) and model.module == module and model.unfold
    assert choose_dispatch(model, True, "cpu") == "eager"
    rng = np.random.default_rng(4)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (5000, 3100, 7999)]
    est = serve(model, wavs, use_bf16=True, device="cpu", bucket_seconds=1.0, batch_size=2)
    apply = jax.jit(jm.apply)
    for idxs in ([1, 0], [2]):  # sorted by length, padded to 1 s (8000 samples)
        mix = np.zeros((len(idxs), SR), np.float32)
        for j, i in enumerate(idxs):
            mix[j, : len(wavs[i])] = wavs[i]
        want = np.asarray(apply(params, mix))
        for j, i in enumerate(idxs):
            _close(est[i], want[j, :, : len(wavs[i])])


def test_dispatch_of_bf16_on_the_card():
    """bf16 TasNet on a CUDA device dispatches to the kernels; f32 or the
    CPU to the module."""
    _, _, tm = tasnet_pair("DPRNN", True)
    assert choose_dispatch(tm, True, "cuda") == "kernels"
    assert choose_dispatch(tm, False, "cuda") == "eager"
    assert choose_dispatch(tm, True, "cpu") == "eager"


def test_plain_versions_switch():
    """``kernels.pick`` gives the kernel wrapper, and its plain version only
    inside ``plain_versions()``; the block restores the choice on exit."""
    assert kernels.pick(fused_attention_bdt, attention_bdt_reference) is fused_attention_bdt
    with kernels.plain_versions():
        assert kernels.pick(fused_attention_bdt, attention_bdt_reference) is attention_bdt_reference
    assert kernels.pick(fused_attention_bdt, attention_bdt_reference) is fused_attention_bdt
