"""The port's TDANet against the JAX package on the CPU, in float32: the
resampling ops and DropPath, the module path with and without weight
sharing, the reference quirks one by one, the analytic-moment fast path
(the JAX package's own pins, case for case) against the port's module path
and the JAX fast path, the weight converter both ways, the attention
dispatch of a bf16 model with the card forced, and the serving dispatch."""

import copy

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import TDANet as JTDANet
from audio_only_speech_separation_tpu.models.tdanet import fast_inference_forward as jax_fast
from audio_only_speech_separation_tpu.ops.resample import adaptive_avg_pool1d as jax_pool
from audio_only_speech_separation_tpu.ops.resample import interpolate_nearest as jax_nearest
from audio_only_speech_separation_tpu.utils.torch_import import convert
from audio_only_speech_separation_tpu_torch.models import TDANet
from audio_only_speech_separation_tpu_torch.models.tdanet import (
    TDAAttention,
    fast_forward_eligible,
    fast_inference_forward,
)
from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops.attention import mha_plain_form
from audio_only_speech_separation_tpu_torch.ops.dropout import DropPath
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import attention_packed_reference
from audio_only_speech_separation_tpu_torch.ops.resample import (
    adaptive_avg_pool1d,
    interpolate_nearest,
)
from audio_only_speech_separation_tpu_torch.serve import Server, choose_dispatch
from audio_only_speech_separation_tpu_torch.utils.jax_import import tdanet_from_jax
from torch_port_helpers import assert_close, assert_same_tree, perturbed, state_numpy

torch.set_num_threads(2)

# widths 16/32, 3 blocks, depth 3, a 4 ms encoder at 16 kHz (k 64)
SMALL = dict(out_channels=16, in_channels=32, num_blocks=3, upsampling_depth=3, enc_kernel_size=4,
             num_sources=2, sample_rate=16000)


def _port_model(seed, **overrides):
    return perturbed(TDANet(**dict(SMALL, **overrides), generator=torch.Generator().manual_seed(seed)),
                     seed)


def _jax_params(model):
    return convert("TDANet", state_numpy(model), upsampling_depth=model.upsampling_depth)


def _waves(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t_in,t_out", [(102, 810), (7, 3), (5, 13), (126, 2010), (63, 126), (9, 9)])
def test_interpolate_nearest_matches_jax_and_torch(t_in, t_out):
    """torch's float32 index rule, exactly, along axis 1 of [B, T, C]."""
    x = _waves(t_in, (2, t_in, 3))
    got = interpolate_nearest(torch.from_numpy(x), t_out, dim=1).numpy()
    lib = torch.nn.functional.interpolate(torch.from_numpy(x).transpose(1, 2), size=t_out,
                                          mode="nearest").transpose(1, 2).numpy()
    assert np.array_equal(got, lib)
    assert np.array_equal(got, np.asarray(jax_nearest(x, t_out, axis=1)))


@pytest.mark.parametrize("t_in,t_out", [(13, 4), (2010, 126), (503, 126), (12, 4), (9, 9), (5, 7)])
def test_adaptive_avg_pool_matches_jax_and_torch(t_in, t_out):
    x = _waves(t_in, (2, t_in, 3))
    got = adaptive_avg_pool1d(torch.from_numpy(x), t_out, dim=1).numpy()
    lib = torch.nn.functional.adaptive_avg_pool1d(torch.from_numpy(x).transpose(1, 2),
                                                  t_out).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, lib, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_pool(x, t_out, axis=1)), rtol=0, atol=1e-6)


def test_drop_path_is_the_identity_in_eval_and_seeded_in_training():
    x = torch.from_numpy(_waves(1, (64, 3, 4)))
    dp = DropPath(0.25, generator=torch.Generator().manual_seed(5))
    assert dp.eval()(x) is x and DropPath(0.0).train()(x) is x
    y = dp.train()(x)
    again = DropPath(0.25, generator=torch.Generator().manual_seed(5)).train()(x)
    assert torch.equal(y, again)
    kept = (y != 0).flatten(1).all(dim=1)
    assert torch.equal(y[kept], x[kept] / 0.75) and not y[~kept].any()
    assert 0 < int((~kept).sum()) < 64


@pytest.mark.parametrize("overrides,shape", [
    ({}, (2, 3000)),
    (dict(unfold=False, num_blocks=2), (2, 3000)),
    (dict(upsampling_depth=2, num_blocks=2), (3, 2500)),
], ids=["unfold", "per_block_weights", "depth2"])
def test_tdanet_matches_jax(overrides, shape):
    """Random port weights in the JAX package's layout: the same output
    within 1e-4 of its scale, at the same batch composition."""
    model = _port_model(1, **overrides)
    if model.unfold:
        params = _jax_params(model)
    else:  # the JAX package converts only the weight-shared model
        params = {"params": _jax_from_port_without_unfold(model)}
        assert set(tdanet_from_jax(params, model.upsampling_depth, model.num_blocks, False)) == \
            set(model.state_dict())
    x = _waves(2, shape)
    want = jax.jit(JTDANet(**dict(SMALL, **overrides)).apply)(params, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_close(got.numpy(), want)


def _jax_from_port_without_unfold(model):
    """The JAX tree of a TDANet without ``unfold`` (``unet_{i}``,
    ``concat_block_{j}``): each block and gate converted as the shared one
    of a weight-shared model."""
    sd = state_numpy(model)

    def shared(i, j):  # block i and gate j under the weight-shared names
        return convert("TDANet", {k.replace(f"sm.unet.{i}.", "sm.unet.").replace(
            f"sm.concat_block.{j}.", "sm.concat_block."): v for k, v in sd.items()},
            upsampling_depth=model.upsampling_depth)["params"]

    sm = {f"unet_{i}": shared(i, 0)["sm"]["unet"] for i in range(model.num_blocks)}
    sm.update({f"concat_block_{j}": shared(0, j)["sm"]["concat_block"]
               for j in range(model.num_blocks - 1)})
    return dict(shared(0, 0), sm=sm)


def test_tdanet_one_d_input():
    model = _port_model(1)
    x = torch.from_numpy(_waves(3, 1777))
    with torch.no_grad():
        got, want = model(x), model(x[None])[0]
    assert got.shape == (2, 1777) and torch.equal(got, want)


def test_attention_runs_over_the_batch_axis_with_a_doubled_residual():
    """The [B, T, C] input goes to the MHA as (batch T, sequence B): an
    utterance's output moves when another one in its batch does; the
    residual is out + dropout(out), twice the output in eval mode."""
    att = perturbed(TDAAttention(32, 8), 3)
    x = torch.from_numpy(_waves(4, (2, 20, 32)))
    m = att.attn
    with torch.no_grad():
        got = att(x)
        h = att.pos_enc(att.attn_in_norm(x)).transpose(0, 1)  # [T, B, C]
        o = mha_plain_form(h, h, h, m.in_proj_weight, m.in_proj_bias, m.out_proj.weight,
                           m.out_proj.bias, 8).transpose(0, 1)
        assert torch.allclose(got, att.norm(2 * o), rtol=0, atol=1e-6)
        other = x.clone()
        other[1] = torch.from_numpy(_waves(5, (20, 32)))
        assert not torch.allclose(att(other)[0], got[0], rtol=0, atol=1e-3)


def test_collapse_fuses_the_scale_above_the_one_below_the_deepest():
    """At i == depth - 2 the top-down collapse fuses ``fused[i - 1]``, not
    the deepest scale, which nothing reads."""
    block = _port_model(1, upsampling_depth=4).sm.unet
    seen = {}
    def keep(name, what):
        def hook(mod, args, out):
            seen[name] = args if what == "args" else out
        return hook

    for i, fus in enumerate(block.loc_glo_fus):
        fus.register_forward_hook(keep(f"fused{i}", "out"))
    block.last_layer[2].register_forward_hook(keep("args", "args"))
    with torch.no_grad():
        block(torch.from_numpy(_waves(5, (1, 64, 16))))
    assert seen["args"][0] is seen["fused2"] and seen["args"][1] is seen["fused1"]


# the JAX package's pins of its fast path (tests/test_tdanet_fast.py), case
# for case: (depth, blocks, T), batch 3, widths 16/32, 4 ms at 16 kHz
FAST_PINS = [(2, 2, 4000), (3, 2, 4000), (4, 2, 8000), (5, 2, 8000), (5, 1, 6399)]


@pytest.mark.parametrize("depth,n_blocks,T", FAST_PINS)
def test_fast_path_matches_module_and_jax_fast_path(depth, n_blocks, T):
    """The port's fast path against the port's module path and the JAX
    package's fast path on the same weights, within 1e-4 of the scale."""
    cfg = dict(upsampling_depth=depth, num_blocks=n_blocks)
    model = _port_model(depth * 10 + n_blocks, **cfg)
    assert fast_forward_eligible(model)
    x = _waves(0, (3, T))
    with torch.no_grad():
        fast = fast_inference_forward(model, torch.from_numpy(x))
        module = model(torch.from_numpy(x))
    jm = JTDANet(**dict(SMALL, **cfg))
    want = jax.jit(lambda p, w: jax_fast(jm, p, w))(_jax_params(model), x)
    assert_close(fast.numpy(), module.numpy())
    assert_close(fast.numpy(), want)


def test_fast_path_refuses_what_it_does_not_serve():
    """No quiet fallback: a TDANet without ``unfold`` is refused, and the
    serving dispatch gives it the module instead."""
    model = _port_model(1, unfold=False, num_blocks=2)
    assert not fast_forward_eligible(model)
    with pytest.raises(ValueError, match="unfold"):
        fast_inference_forward(model, torch.zeros(1, 800))
    assert choose_dispatch(model, True, "cuda") == "kernels"
    assert choose_dispatch(model, True, "cpu") == choose_dispatch(model, False, "cuda") == "eager"
    for use_bf16, device in ((True, "cuda"), (False, "cuda"), (True, "cpu"), (False, "cpu")):
        assert choose_dispatch(_port_model(1), use_bf16, device) == "fast_tdanet"


def test_served_fast_path_on_the_cpu():
    """``Server`` on the CPU runs the fast path in float32, whatever the
    bf16 flag, in eval mode from a module left in training mode."""
    model = _port_model(2).train()
    server = Server(model, True, "cpu", bucket_seconds=0.25)
    assert server.dispatch == "fast_tdanet" and server.model is model
    wavs = [_waves(6, 3000), _waves(7, 2100)]
    est = server(wavs)
    assert model.training
    mix = np.zeros((2, 4000), np.float32)
    for j, w in enumerate(wavs):
        mix[j, : len(w)] = w
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(mix)).numpy()
    for j, w in enumerate(wavs):
        assert_close(est[j], want[j, :, : len(w)])


def test_tdanet_from_jax_round_trip():
    """A JAX parameter tree gives the JAX output through the port, and
    converting the port's weights back gives the same tree; a one-block
    model, whose JAX tree has no gate, loads too."""
    jm = JTDANet(**SMALL)
    params = _jax_params(_port_model(8))
    model = TDANet(**SMALL)
    sd = tdanet_from_jax(params, SMALL["upsampling_depth"], SMALL["num_blocks"])
    assert set(sd) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    x = _waves(9, (2, 3000))
    with torch.no_grad():
        assert_close(model.eval()(torch.from_numpy(x)).numpy(), jax.jit(jm.apply)(params, x))
    assert_same_tree(params, _jax_params(model))
    one = dict(params["params"], sm={"unet": params["params"]["sm"]["unet"]})
    sd = tdanet_from_jax({"params": one}, SMALL["upsampling_depth"], 1)
    assert set(sd) == set(model.state_dict())


@pytest.fixture
def attention_calls(monkeypatch):
    """Dispatch treats every tensor as a kernel input; K4's packed entry
    is a stand-in that records its shapes as [B*h, dh, T] and returns the
    plain result."""
    calls = []

    def stand_in(qkv, num_heads):
        B, T, E3 = qkv.shape
        calls.append((B * num_heads, E3 // (3 * num_heads), T))  # as [B*h, dh, T]
        return attention_packed_reference(qkv, num_heads)

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_attention, "fused_attention_packed", stand_in)
    return calls


def test_bf16_tdanet_attention_dispatch(attention_calls):
    """With the card forced, a bf16 TDANet's module path sends each block's
    attention to K4 at [T_deep * 8, dh, B] (in 64, dh 8; 3000 samples give
    T' 198, T_deep 50), once a block; the fast path never calls it; both
    stay near the float32 module."""
    model = _port_model(10, in_channels=64)
    x = torch.from_numpy(_waves(11, (2, 3000)))
    with torch.no_grad():
        ref = model(x)
        attention_calls.clear()
        bf16 = copy.deepcopy(model).to(torch.bfloat16)
        out = bf16(x.to(torch.bfloat16))
        assert attention_calls == [(50 * 8, 8, 2)] * SMALL["num_blocks"]
        fast = fast_inference_forward(bf16, x.to(torch.bfloat16))
    assert attention_calls == [(50 * 8, 8, 2)] * SMALL["num_blocks"]
    for y in (out, fast):
        assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
        assert float((y.float() - ref).norm() / ref.norm()) < 0.1
