"""The port's TasNet with group communication (``group_size`` 2: the
context GC_RNNs around the separator, a TAC before each layer of the
DPRNN and DPTNet cores, the grouped mask head) against the JAX package on
the CPU, in float32: the whole model with the weight converter both ways,
a JAX-written checkpoint served through the port, and one train step's
loss and gradients.

Tolerance: the whole model within 1e-4 of its output's scale (float32, as
the TasNet tests); the train step as ``train_step_against_jax`` states."""

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import TasNet as JTasNet
from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.utils.torch_import import convert_tasnet
from audio_only_speech_separation_tpu_torch.models import TasNet, from_pretrain
from audio_only_speech_separation_tpu_torch.serve import choose_dispatch, serve
from audio_only_speech_separation_tpu_torch.utils.jax_import import tasnet_from_jax
from torch_port_helpers import assert_close, perturbed, port_pair, train_step_against_jax

torch.set_num_threads(2)

SR = 8000
# small widths, one layer, 8-frame context windows, 12-frame chunks, two groups
SMALL = dict(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=1, num_spk=2, block_size=12,
             context_size=8, sample_rate=SR, group_size=2)

_PAIRS = {}


def tasnet_pair(module):
    """(JAX model, its params as numpy, port model with the same weights)."""
    if module not in _PAIRS:
        jm = JTasNet(**SMALL, module=module)
        _PAIRS[module] = (jm, *port_pair(jm, TasNet(**SMALL, module=module),
                                         lambda p: tasnet_from_jax(p, module, 1, False, 2), 400))
    return _PAIRS[module]


@pytest.mark.parametrize("module", ["DPRNN", "DPTNet"])
def test_grouped_dual_path_tasnet_matches_jax_and_round_trips(module):
    """B=2 x 0.15 s through the context squeeze, the grouped core and the
    context decode: within 1e-4 of the output's scale; and
    convert_tasnet(tasnet_from_jax(p)) gives p back, leaf for leaf."""
    jm, params, tm = tasnet_pair(module)
    x = np.random.default_rng(1).standard_normal((2, 1201)).astype(np.float32)
    with torch.no_grad():
        assert_close(tm(torch.from_numpy(x)).numpy(), np.asarray(jax.jit(jm.apply)(params, x)))
    back = convert_tasnet(tasnet_from_jax(params, module, 1, False, 2), module=module, layer=1, group_size=2)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path], np.float32), leaf), path


def test_jax_checkpoint_serves_through_the_port(tmp_path):
    """A DPTNet TasNet (group size 2) checkpoint the JAX package wrote loads
    through ``from_pretrain`` and serves through ``serve`` on the CPU
    against the JAX model on serve's padded batch; with bf16 on the card it
    would be served as "kernels"."""
    jm, params, _ = tasnet_pair("DPTNet")
    ckpt = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), ckpt)
    model = from_pretrain(ckpt, device="cpu")
    assert isinstance(model, TasNet) and model.module == "DPTNet" and model.group_size == 2
    assert choose_dispatch(model, True, "cuda") == "kernels"
    wav = np.random.default_rng(4).standard_normal(3100).astype(np.float32)
    est = serve(model, [wav], use_bf16=True, device="cpu", bucket_seconds=0.5)
    mix = np.zeros((1, SR // 2), np.float32)
    mix[0, : len(wav)] = wav
    assert_close(est[0], np.asarray(jax.jit(jm.apply)(params, mix))[0, :, : len(wav)])


def test_f32_train_step_matches_jax():
    """One f32 train step (PIT pairwise neg-SNR) of a DPRNN TasNet with group
    size 2 (the context GC_RNNs, the TACs of the core) against
    ``jax.value_and_grad`` of the JAX model on the same weights."""
    model = perturbed(TasNet(**SMALL, module="DPRNN", generator=torch.Generator().manual_seed(5)), 5)
    rng = np.random.default_rng(6)
    sources = (0.3 * rng.standard_normal((2, 2, 1200))).astype(np.float32)
    train_step_against_jax(JTasNet(**SMALL, module="DPRNN"), model,
                           lambda sd: convert_tasnet(sd, module="DPRNN", layer=1, group_size=2),
                           sources.sum(1), sources)
