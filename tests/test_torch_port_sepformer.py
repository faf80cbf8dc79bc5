"""The port's Sepformer against the JAX package on the CPU, in float32: the
sinusoidal table, the whole model on shared weights in every norm and mask
variant, the weight converter both ways, a JAX-written checkpoint served
in eval mode from a module left in training mode, and the attention
dispatch with the card forced."""

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import Sepformer as JSepformer
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.ops.attention import sinusoidal_positions as jax_positions
from audio_only_speech_separation_tpu.utils.separator import separate as jax_separate
from audio_only_speech_separation_tpu.utils.torch_import import convert
from audio_only_speech_separation_tpu_torch.models import Sepformer, from_pretrain
from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.attention import sinusoidal_positions
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import attention_bdt_reference
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch, serve
from audio_only_speech_separation_tpu_torch.utils.jax_import import sepformer_from_jax
from audio_only_speech_separation_tpu_torch.utils.separator import separate

torch.set_num_threads(2)

SR = 8000
# N 32, 4 heads (dh 8), 2 intra and 2 inter layers, d_ffn 64, chunks of 20
# frames, 2 dual blocks, 2 speakers, k 16
SMALL = dict(encoder_kernel_size=16, encoder_out_nchannels=32, masknet_chunksize=20,
             masknet_numlayers=2, masknet_numspks=2, intra_numlayers=2, inter_numlayers=2,
             intra_nhead=4, inter_nhead=4, intra_dffn=64, inter_dffn=64, sample_rate=SR)
DEPTHS = dict(masknet_numlayers=2, intra_numlayers=2, inter_numlayers=2)


def _close(got, want):
    """float32 in both packages: max error <= 1e-4 of the output's scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _port_model(seed, **overrides):
    """A port Sepformer with random weights: the seeded init with every
    parameter moved by 0.1-scaled noise (norm affines, biases and the PReLU
    slope included), in eval mode."""
    m = Sepformer(**dict(SMALL, **overrides), generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.from_numpy((0.1 * rng.standard_normal(p.shape)).astype(np.float32)))
    return m.eval()


def _jax_params(model):
    return convert("Sepformer", {k: v.numpy() for k, v in model.state_dict().items()}, **DEPTHS)


@pytest.mark.parametrize("d_model,max_len", [(8, 30), (7, 30), (256, 250)])
def test_sinusoidal_positions_match_jax(d_model, max_len):
    """The float64 table rounded once, the odd-width cosine slice included."""
    for dtype, jdtype in ((torch.float32, np.float32), (torch.bfloat16, jax.numpy.bfloat16)):
        got = sinusoidal_positions(max_len, d_model, dtype)
        want = np.asarray(jax_positions(max_len, d_model, jdtype), np.float32)
        assert got.dtype == dtype and np.array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("norm_before", [True, False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 1234), (777,)], ids=["batch", "one_d"])
def test_sepformer_matches_jax(norm_before, causal, shape):
    """Random port weights converted with the JAX package's converter: the
    same output within 1e-4 of its scale, at T not a multiple of a chunk
    and for a 1-D input."""
    variant = dict(intra_norm_before=norm_before, inter_norm_before=norm_before,
                   intra_causal=causal, inter_causal=causal)
    model = _port_model(1, **variant)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = JSepformer(**SMALL, **variant).apply(_jax_params(model), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_sepformer_from_jax_round_trip():
    """JAX-initialised params give the JAX output through the port, and
    converting the port's weights back gives the same tree."""
    jm = JSepformer(**SMALL)
    x = np.random.default_rng(3).standard_normal((2, 900)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4), x))
    sd = sepformer_from_jax(params, **DEPTHS)
    model = Sepformer(**SMALL)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd.items()})
    with torch.no_grad():
        _close(model.eval()(torch.from_numpy(x)).numpy(), jm.apply(params, x))
    back = convert("Sepformer", {k: v.numpy() for k, v in model.state_dict().items()}, **DEPTHS)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b and all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(JAX model, its params, a best_model.pth the JAX package wrote); the
    model keeps the default dropout 0.1."""
    jm = JSepformer(**SMALL)
    params = _jax_params(_port_model(5))
    path = str(tmp_path_factory.mktemp("sepformer") / "best_model.pth")
    jax_save(jax_serialize(jm, params), path)
    return jm, params, path


def test_served_from_a_training_mode_module_in_eval_mode(jax_checkpoint):
    """``serve`` runs the forward in eval mode whatever the module's mode:
    a checkpoint loaded by ``from_pretrain`` (training mode, dropout 0.1)
    gives the JAX ``apply`` output (``train=False``) on bucketed batches,
    the same arrays twice, and keeps its ``training`` flag."""
    jm, params, path = jax_checkpoint
    model = from_pretrain(path, device="cpu")
    assert model.training and model.dropout == 0.1
    rng = np.random.default_rng(6)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (9100, 3000, 5555)]
    est = serve(model, wavs, use_bf16=True, device="cpu", bucket_seconds=1.0, batch_size=2)
    again = serve(model, wavs, use_bf16=True, device="cpu", bucket_seconds=1.0, batch_size=2)
    assert model.training and all(m.training for m in model.modules())
    apply = jax.jit(jm.apply)
    # sorted by length, padded to 1 s (8000-sample) multiples: [3000, 5555]
    # -> 8000, [9100] -> 16000
    for idxs, T_pad in (([1, 2], 8000), ([0], 16000)):
        mix = np.zeros((len(idxs), T_pad), np.float32)
        for j, i in enumerate(idxs):
            mix[j, : len(wavs[i])] = wavs[i]
        want = np.asarray(apply(params, mix))
        for j, i in enumerate(idxs):
            assert np.array_equal(est[i], again[i])
            _close(est[i], want[j, :, : len(wavs[i])])


def test_separated_from_a_training_mode_module_in_eval_mode(jax_checkpoint):
    """``separate`` likewise: the JAX ``separate`` output, twice the same,
    the module's mode kept."""
    jm, params, path = jax_checkpoint
    model = from_pretrain(path, device="cpu")
    wav = np.random.default_rng(7).standard_normal((2, 4100)).astype(np.float32)
    got, again = separate(model, wav), separate(model, wav)
    assert model.training and np.array_equal(got, again)
    _close(got, np.asarray(jax_separate(jm, params, wav)))


@pytest.fixture
def attention_calls(monkeypatch):
    """Dispatch treats every tensor as a kernel input; the attention kernel
    is a stand-in that counts its calls and returns the plain result."""
    calls = []

    def stand_in(q, k, v):
        calls.append(tuple(q.shape))
        return attention_bdt_reference(q, k, v)

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_attention, "fused_attention_bdt", stand_in)
    return calls


@pytest.mark.parametrize("mode,causal,kernel_calls", [
    ("eval", False, 2 * (2 + 2)),  # every attention: 2 dual blocks x (intra + inter)
    ("train", False, 0),  # dropout 0.1 on the attention weights
    ("eval", True, 0),  # a causal mask
])
def test_bf16_sepformer_attention_dispatch(attention_calls, mode, causal, kernel_calls):
    """With the card forced, a bf16 Sepformer in eval mode sends every
    attention layer to the kernel form (the intra pass at [B*S*h, dh, K],
    the inter pass at [B*K*h, dh, S]); in training mode with dropout, or
    with a causal mask, none."""
    model = _port_model(8, intra_causal=causal, inter_causal=causal).to(torch.bfloat16)
    model.train(mode == "train")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 1000)).astype(np.float32))
    with torch.no_grad():
        out = model(x.to(torch.bfloat16))
    assert out.shape == (2, 2, 1000) and torch.isfinite(out.float()).all()
    assert len(attention_calls) == kernel_calls
    if kernel_calls:  # L = 124 frames -> S = 14 chunks of K = 20; h = 4, dh = 8
        assert set(attention_calls) == {(2 * 14 * 4, 8, 20), (2 * 20 * 4, 8, 14)}


def test_choose_dispatch_serves_sepformer_through_the_kernels():
    """A bf16 Sepformer on the card takes the "kernels" dispatch; f32 or the
    CPU take the module itself."""
    model = Sepformer(**SMALL)
    assert choose_dispatch(model, True, "cuda") == "kernels"
    assert choose_dispatch(model, False, "cuda") == "eager"
    assert choose_dispatch(model, True, "cpu") == "eager"
