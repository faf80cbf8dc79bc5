"""The port's AFRCNN against the JAX package on the CPU, in float32: the
whole model on shared weights, the weight converter both ways, and a bf16
copy of the module, which runs no kernel."""

import copy

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import AFRCNN as JAFRCNN
from audio_only_speech_separation_tpu.utils.torch_import import convert
from audio_only_speech_separation_tpu_torch.models import AFRCNN, from_pretrain, serialize
from audio_only_speech_separation_tpu_torch.ops import attention as port_attention
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch
from audio_only_speech_separation_tpu_torch.utils.jax_import import afrcnn_from_jax
from torch_port_helpers import assert_close, assert_same_tree, perturbed, state_numpy

torch.set_num_threads(2)

# widths 16/32, 3 blocks, depth 3, a 1 ms encoder at 16 kHz (k 16)
SMALL = dict(out_channels=16, in_channels=32, num_blocks=3, upsampling_depth=3, enc_kernel_size=1,
             num_sources=2, sample_rate=16000)


def _port_model(seed, **overrides):
    return perturbed(AFRCNN(**dict(SMALL, **overrides), generator=torch.Generator().manual_seed(seed)),
                     seed)


def _jax_params(model):
    return convert("AFRCNN", state_numpy(model), upsampling_depth=model.upsampling_depth)


def _waves(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("overrides,shape", [
    ({}, (2, 3000)),
    (dict(upsampling_depth=4, num_blocks=2), (1, 2345)),
    (dict(upsampling_depth=2, num_blocks=1, sample_rate=8000), (2, 1601)),
], ids=["depth3", "depth4_odd_length", "depth2_one_block_8k"])
def test_afrcnn_matches_jax(overrides, shape):
    """Random port weights through the JAX package's converter: the same
    output within 1e-4 of its scale."""
    model = _port_model(1, **overrides)
    x = _waves(2, shape)
    want = jax.jit(JAFRCNN(**dict(SMALL, **overrides)).apply)(_jax_params(model), x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_close(got.numpy(), want)


def test_afrcnn_from_jax_round_trip():
    """A JAX parameter tree gives the JAX output through the port, and
    converting the port's weights back gives the same tree; the port's
    checkpoint reloads; a one-block model, whose JAX tree has no gate,
    loads too."""
    jm = JAFRCNN(**SMALL)
    params = _jax_params(_port_model(3))
    model = AFRCNN(**SMALL)
    sd = afrcnn_from_jax(params, SMALL["upsampling_depth"])
    assert set(sd) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()})
    x = _waves(4, (2, 3000))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert_close(got.numpy(), jax.jit(jm.apply)(params, x))
    assert_same_tree(params, _jax_params(model))
    again = from_pretrain(serialize(model), device="cpu").eval()
    with torch.no_grad():
        assert torch.equal(again(torch.from_numpy(x)), got)
    one = {"params": dict(params["params"], sm={"blocks": params["params"]["sm"]["blocks"]})}
    assert set(afrcnn_from_jax(one, SMALL["upsampling_depth"])) == set(model.state_dict())


def test_bf16_afrcnn_runs_no_kernel(monkeypatch):
    """On the card AFRCNN serves as "kernels", a bf16 copy of the module;
    with the card forced it calls none of K4-K6, and stays near the float32
    module."""
    model = _port_model(5)
    assert choose_dispatch(model, True, "cuda") == "kernels"
    assert choose_dispatch(model, False, "cuda") == choose_dispatch(model, True, "cpu") == "eager"

    def no_kernel(*args):
        raise AssertionError("a kernel was called")

    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    for module, name in ((port_attention, "fused_attention_bdt"), (port_attention, "fused_attention_packed"),
                         (port_rnn, "fused_bilstm"), (port_rnn, "resident_bilstm")):
        monkeypatch.setattr(module, name, no_kernel)
    x = torch.from_numpy(_waves(6, (1, 3000)))
    with torch.no_grad():
        ref = model(x)
        out = copy.deepcopy(model).to(torch.bfloat16)(x.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert float((out.float() - ref).norm() / ref.norm()) < 0.1
