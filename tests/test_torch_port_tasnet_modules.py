"""The rest of the port's TasNet family against the JAX package on the CPU,
in float32: TAC, GC_RNN, TCN, GC_TCN, UConvBlock and GC_UConvBlock as
modules; TasNet with the TCN and SudoRM-RF separator modules (TCN,
SudoRMRF, GC_TCN, GC_SudoRMRF) with the weight converter both ways; and
the kernels' launches a call of every module with group communication.
The dual-path cores with group communication, a JAX-written checkpoint
and a train step are in ``test_torch_port_tasnet_groups.py``.

Tolerance: rtol = atol = 1e-5 on the modules; the whole model within 1e-4
of its output's scale (float32, as the TasNet tests)."""

import jax
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.models import TasNet as JTasNet
from audio_only_speech_separation_tpu.models import blocks as jblocks
from audio_only_speech_separation_tpu.utils.torch_import import convert_tasnet
from audio_only_speech_separation_tpu_torch.models import TasNet, blocks
from audio_only_speech_separation_tpu_torch.utils import jax_import
from torch_port_helpers import (
    assert_close,
    count_kernel_launches,
    draw_tree,
    port_pair,
)

torch.set_num_threads(2)

SR = 8000
# small widths, one layer (two TCN blocks: stack 2), 8-frame context windows, 12-frame chunks
SMALL = dict(enc_dim=16, bn_dim=16, hidden_dim=16, win=16, layer=1, num_spk=2, block_size=12,
             context_size=8, sample_rate=SR)
TOL = dict(rtol=1e-5, atol=1e-5)
# the separator modules without a recurrent core at both group sizes (the
# dual-path cores: test_torch_port_tasnet.py at 1, test_torch_port_tasnet_groups.py at 2)
CONFIGS = [("TCN", 1), ("TCN", 2), ("SudoRMRF", 1), ("SudoRMRF", 2), ("GC_TCN", 2), ("GC_SudoRMRF", 2)]


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def module_pair(jax_module, port_module, convert, *inputs):
    """(JAX output, port output) of one module on ``inputs`` with the same
    weights: the JAX tree drawn by ``draw_tree``, carried into the port
    module by ``convert(sd, prefix, tree)`` (a ``utils/jax_import.py``
    helper) under a prefix that is then dropped."""
    params = draw_tree(jax_module.init(jax.random.PRNGKey(0), *inputs), np.random.default_rng(7))
    sd = {}
    convert(sd, "m", params["params"])
    sd = {k.removeprefix("m."): v for k, v in sd.items()}
    assert set(sd) == set(port_module.state_dict())
    port_module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        return np.asarray(jax_module.apply(params, *inputs)), port_module(*(t(a) for a in inputs)).numpy()


def test_tac_matches_jax():
    """TAC on [B, G, N, T]: per-group Linear + PReLU, their mean, concat,
    Linear + PReLU, gLN (eps 1e-5) per group, residual."""
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 11)).astype(np.float32)
    want, got = module_pair(jblocks.TAC(8, 12), blocks.TAC(8, 12), jax_import._tac, x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_gc_rnn_matches_jax(bidirectional):
    """GC_RNN on [B, dim, T], two layers of TAC, ProjRNN and gLN over two
    groups."""
    x = np.random.default_rng(1).standard_normal((3, 16, 9)).astype(np.float32)
    jm = jblocks.GC_RNN(16, 16, num_group=2, num_layers=2, bidirectional=bidirectional)
    pm = blocks.GC_RNN(16, 16, num_group=2, num_layers=2, bidirectional=bidirectional)
    want, got = module_pair(jm, pm, jax_import._gc_rnn, x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("grouped", [False, True], ids=["TCN", "GC_TCN"])
def test_tcn_matches_jax(grouped):
    """TCN (gLN, bottleneck, 2 x 2 dilated depthwise blocks, skips summed,
    PReLU + 1x1) and GC_TCN (a TAC before each block, a per-group head)."""
    x = np.random.default_rng(2).standard_normal((2, 16, 30)).astype(np.float32)
    if grouped:
        jm, pm = jblocks.GC_TCN(16, 16, 32, 2, 2, num_group=2), blocks.GC_TCN(16, 16, 32, 2, 2, num_group=2)
    else:
        jm, pm = jblocks.TCN(16, 16, 12, 32, 2, 2), blocks.TCN(16, 16, 12, 32, 2, 2)
    want, got = module_pair(jm, pm, lambda sd, pre, p: jax_import._tcn(sd, pre, p, 4, grouped), x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T", [37, 64])
@pytest.mark.parametrize("grouped", [False, True], ids=["UConvBlock", "GC_UConvBlock"])
def test_uconv_block_matches_jax(grouped, T):
    """SudoRM-RF's U-ConvBlock at depth 4 (odd and even lengths: the
    collapse crops and pads the upsampled scales), and the grouped block
    behind a TAC."""
    x = np.random.default_rng(T).standard_normal((2, 16, T)).astype(np.float32)
    if grouped:
        jm, pm = jblocks.GC_UConvBlock(16, 32, 4, num_group=2), blocks.GC_UConvBlock(16, 32, 4, num_group=2)

        def convert(sd, pre, p):
            jax_import._tac(sd, f"{pre}.TAC", p["tac"])
            jax_import._uconv_block(sd, f"{pre}.UBlock", p["ublock"], 4)
    else:
        jm, pm = jblocks.UConvBlock(16, 32, 4), blocks.UConvBlock(16, 32, 4)

        def convert(sd, pre, p):
            jax_import._uconv_block(sd, pre, p, 4)
    want, got = module_pair(jm, pm, convert, x)
    np.testing.assert_allclose(got, want, **TOL)


_PAIRS = {}


def tasnet_pair(module, G):
    """(JAX model, its params as numpy, port model with the same weights),
    made once per config."""
    if (module, G) not in _PAIRS:
        cfg = dict(SMALL, module=module, group_size=G)
        jm = JTasNet(**cfg)
        params, tm = port_pair(jm, TasNet(**cfg), lambda p: jax_import.tasnet_from_jax(p, module, 1, False, G),
                               400)
        _PAIRS[module, G] = (jm, params, tm)
    return _PAIRS[module, G]


@pytest.mark.parametrize("module,G", CONFIGS, ids=[f"{m}-G{g}" for m, g in CONFIGS])
def test_tasnet_matches_jax_and_round_trips(module, G):
    """The whole model with each separator module and group size, same
    weights, B=2 x 0.15 s: within 1e-4 of the output's scale; and
    convert_tasnet(tasnet_from_jax(p)) gives p back, leaf for leaf."""
    jm, params, tm = tasnet_pair(module, G)
    x = np.random.default_rng(1).standard_normal((2, 1201)).astype(np.float32)
    with torch.no_grad():
        assert_close(tm(t(x)).numpy(), np.asarray(jax.jit(jm.apply)(params, x)))
    sd = jax_import.tasnet_from_jax(params, module, 1, False, G)
    back = convert_tasnet(sd, module=module, layer=1, group_size=G)
    flat_p = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_p) == len(flat_b)
    for path, leaf in flat_p:
        assert np.array_equal(np.asarray(flat_b[path], np.float32), leaf), path


# launch counts at B=4 x 0.3 s (302 frames: 78 context windows of 8, then 16 chunks of 12)
LAUNCH_CFG = dict(SMALL, bn_dim=64, hidden_dim=32)  # head width 8 (K4), LSTM widths 16 and 64 (K6)


@pytest.mark.parametrize("module,G,counts", [
    ("TCN", 1, {"K4": 0, "K5": 0, "K6": 0}), ("SudoRMRF", 1, {"K4": 0, "K5": 0, "K6": 0}),
    ("GC_TCN", 2, {"K4": 0, "K5": 0, "K6": 4}), ("GC_SudoRMRF", 2, {"K4": 0, "K5": 0, "K6": 4}),
    ("DPRNN", 2, {"K4": 0, "K5": 0, "K6": 6}), ("DPTNet", 2, {"K4": 2, "K5": 0, "K6": 6}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_kernel_launches_a_call(monkeypatch, module, G, counts):
    """With the kernels' dispatch taken (as for bf16 on the card), B=4 x
    0.3 s: TCN and SudoRM-RF run no kernel; each context GC_RNN layer (4 a
    call, 4 x 78 windows x 2 groups = 624 sequences) is a K6 launch; the
    grouped core's rows (4 x 2 x 16 = 128 sequences) and columns (96)
    take K6 too (their input is 8 wide), DPTNet's attention K4 for both;
    the kernel form, here with the plain versions, within 1e-5 of the
    plain form."""
    tm = TasNet(**LAUNCH_CFG, module=module, group_size=G, generator=torch.Generator().manual_seed(2)).eval()
    x = t(np.random.default_rng(8).standard_normal((4, 2400)))
    with torch.no_grad():
        want = tm(x)
    got, launched = count_kernel_launches(monkeypatch, lambda: tm(x))
    assert launched == counts
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
