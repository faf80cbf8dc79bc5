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
from audio_only_speech_separation_tpu_torch.models import Sepformer, from_pretrain, sepformer
from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.attention import sinusoidal_positions
from audio_only_speech_separation_tpu_torch.ops.kernels.add_layer_norm import (
    add_layer_norm_launches,
    add_layer_norm_ok,
    add_layer_norm_reference,
    fused_add_layer_norm,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import attention_packed_reference
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
    """Dispatch treats every tensor as a kernel input; K4's packed entry,
    which the attention layers call, is a stand-in that records each call
    as its [B*h, dh, T] and returns the plain result."""
    calls = []

    def stand_in(qkv, num_heads):
        B, T, E3 = qkv.shape
        calls.append((B * num_heads, E3 // (3 * num_heads), T))  # as [B*h, dh, T]
        return attention_packed_reference(qkv, num_heads)

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_attention, "fused_attention_packed", stand_in)
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


# ---------------------------------------------------------------------------
# The residual add and LayerNorm sites (K8) of the pre-norm stacks
# ---------------------------------------------------------------------------


class _Seen:
    """What ``fuses_add_norm`` reads of an input [2, 5, d], so that a CUDA
    tensor's edges can be set on a host without a card."""

    def __init__(self, d=32, is_cuda=True, dtype=torch.bfloat16, requires_grad=False, contiguous=True):
        self.shape, self.is_cuda, self.dtype, self.requires_grad = (2, 5, d), is_cuda, dtype, requires_grad
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


def _stack(d=32, norm_before=True, dropout=0.1, dtype=torch.bfloat16, training=False, frozen=False, layers=2):
    block = sepformer.SBTransformerBlock(layers, d, 4, 64, use_positional_encoding=True, norm_before=norm_before,
                                         dropout=dropout)
    block = block.to(dtype).train(training).requires_grad_(not frozen)
    return block.mdl


# (stack, input, grad mode, taken): the envelope's edges, each changing one
# thing from the first case
FUSE_EDGES = {
    "taken": (dict(), dict(), False, True),
    "cpu": (dict(), dict(is_cuda=False), False, False),
    "float32 input": (dict(), dict(dtype=torch.float32), False, False),
    "float32 norms": (dict(dtype=torch.float32), dict(), False, False),
    "not contiguous": (dict(), dict(contiguous=False), False, False),
    "grad recorded": (dict(), dict(), True, False),
    "grad mode, nothing requires it": (dict(frozen=True), dict(), True, True),
    "grad mode, the input requires it": (dict(frozen=True), dict(requires_grad=True), True, False),
    "training, dropout 0.1": (dict(training=True), dict(), False, False),
    "training, dropout 0": (dict(training=True, dropout=0.0), dict(), False, True),
    "post-norm": (dict(norm_before=False), dict(), False, False),
    "d 1024": (dict(d=1024, layers=1), dict(d=1024), False, True),
    "d 1032": (dict(d=1032, layers=1), dict(d=1032), False, False),
    "d 36": (dict(d=36), dict(d=36), False, False),
    "no layers": (dict(layers=0), dict(), False, False),
}


@pytest.mark.parametrize("case", list(FUSE_EDGES))
def test_add_norm_fusion_rule_at_its_edges(case):
    """K8 takes a stack's sites only for a contiguous bf16 CUDA input with
    bf16 norms, d % 8 == 0 and d <= 1024, pre-norm layers, dropout inactive
    and no gradient recorded: each edge alone turns it off."""
    stack_kw, seen_kw, grad, taken = FUSE_EDGES[case]
    stack = _stack(**stack_kw)
    with torch.set_grad_enabled(grad):
        assert sepformer.fuses_add_norm(stack, _Seen(**seen_kw)) is taken


@pytest.fixture
def add_norm_calls(monkeypatch):
    """K8's wrapper as the stacks call it, replaced by a stand-in that
    records each call as (x's shape, the addend's, final) and returns the
    plain result."""
    calls = []

    def stand_in(x, addend, weight, bias, eps, final=False):
        calls.append((tuple(x.shape), tuple(addend.shape), final))
        return add_layer_norm_reference(x, addend, weight, bias, eps, final)

    monkeypatch.setattr(sepformer, "fused_add_layer_norm", stand_in)
    return calls


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("norm_before", [True, False])
def test_add_norm_sites_keep_the_stack_bit_for_bit(add_norm_calls, monkeypatch, norm_before, causal):
    """With the card forced, a bf16 stack in eval mode through the fused
    sites (K8's plain version) gives bit for bit what its layers' own
    forward gives after the positions are added (the stack before the
    fusion): pre-norm through 1 + 2 x layers sites, the last one final,
    post-norm through none."""
    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    block = sepformer.SBTransformerBlock(3, 32, 4, 64, use_positional_encoding=True, norm_before=norm_before,
                                         is_causal=causal)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(torch.from_numpy((0.1 * rng.standard_normal(p.shape)).astype(np.float32)))
    block = block.to(torch.bfloat16).eval()
    x = torch.from_numpy(rng.standard_normal((3, 20, 32)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = block(x)
        mask = torch.tril(torch.ones(20, 20, dtype=torch.bool))[None, None] if causal else None
        want = block.pos_enc(x)
        for layer in block.mdl.layers:
            want = layer(want, mask)
        want = block.mdl.norm(want)
    assert torch.equal(got, want)
    if norm_before:
        assert add_norm_calls == [((3, 20, 32), (20, 32), False)] + [((3, 20, 32), (3, 20, 32), False)] * 5 + [
            ((3, 20, 32), (3, 20, 32), True)]
    else:
        assert add_norm_calls == []


@pytest.mark.parametrize("norm_before", [True, False])
def test_add_norm_sites_keep_the_model_bit_for_bit(add_norm_calls, monkeypatch, norm_before):
    """The whole bf16 Sepformer with the card forced: the same output bit
    for bit with the fused sites and with the rule turned off, through
    2 dual blocks x 2 stacks x (1 + 2 x 2) sites pre-norm, none post-norm."""
    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    model = _port_model(12, intra_norm_before=norm_before, inter_norm_before=norm_before).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal((2, 1000)).astype(np.float32))
    with torch.no_grad():
        got = model(x.to(torch.bfloat16))
        monkeypatch.setattr(sepformer, "fuses_add_norm", lambda stack, x: False)
        want = model(x.to(torch.bfloat16))
    assert torch.equal(got, want)
    assert len(add_norm_calls) == (2 * 2 * 5 if norm_before else 0)


@pytest.mark.parametrize("path", ["cpu eval", "forced training", "forced eval with gradients"])
def test_cpu_and_training_paths_take_no_add_norm_kernel(add_norm_calls, monkeypatch, path):
    """A bf16 Sepformer on the CPU, or with the card forced but training
    (dropout 0.1) or recording gradients, calls K8's wrapper at no site and
    launches nothing."""
    model = _port_model(14).to(torch.bfloat16)
    if path != "cpu eval":
        monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    model.train(path == "forced training")
    before = add_layer_norm_launches.launches
    x = torch.from_numpy(np.random.default_rng(15).standard_normal((2, 1000)).astype(np.float32))
    with torch.set_grad_enabled(path == "forced eval with gradients"):
        out = model(x.to(torch.bfloat16))
    assert torch.isfinite(out.float()).all()
    assert add_norm_calls == [] and add_layer_norm_launches.launches == before


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("addend", ["residual", "positions"])
def test_add_layer_norm_on_the_cpu_is_its_plain_version(final, addend):
    """On a CPU tensor K8's wrapper runs its plain version: torch's add and
    ``F.layer_norm``, s returned unless ``final``; a bad width or addend
    raises only on the card, where the kernel is."""
    rng = np.random.default_rng(16)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    x, w, b = t(3, 7, 24), t(24), t(24)
    a = t(3, 7, 24) if addend == "residual" else t(7, 24)
    got = fused_add_layer_norm(x, a, w, b, 1e-6, final=final)
    s = x + a
    h = torch.nn.functional.layer_norm(s, (24,), w, b, 1e-6)
    if final:
        assert torch.equal(got, h)
    else:
        assert torch.equal(got[0], s) and torch.equal(got[1], h)
    assert add_layer_norm_ok(24) and add_layer_norm_ok(1024) and not add_layer_norm_ok(1032)
    assert not add_layer_norm_ok(12) and not add_layer_norm_ok(0)
