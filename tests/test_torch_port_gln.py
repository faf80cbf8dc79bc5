"""gLN with the residual in one pass (K9, ``ops/kernels/global_layer_norm.py``)
and the rule by which ``ops/norms.py::GlobalLayerNorm`` takes it.

On the CPU: the envelope; the rule true on a channels-last bf16 input
with the card forced (``kernels.kernel_input``) and false at each of its
edges, where the forward calls no wrapper and gives the plain path bit for
bit; the plain version, the module's ``residual`` argument and the CPU
wrapper each bit for bit ``r + GlobalLayerNorm(x)``; a Sandglasset call
with the card forced takes K9 at its 15 gLNs (12 with a residual) and
gives the plain path's output bit for bit; K9's yardstick
(``port_bench/gln_work.py``: 15 gLNs and 1.563 ms of least time a request
of the Sandglasset cell) and its two readers on hand-built traces, with K9
and without it.

On the card (marker ``cuda``): a served Sandglasset request at the cell's
8 x 4.0 s runs exactly 15 K9 gLNs (15 of each pass on the device) and meets
the 1.5x rule; a TDANet module-path call at tdanet_lrs2's width takes K9
and meets it too.  K9 against its plain version at the cell's shapes and
the edges is in ``test_torch_port_cuda.py``.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_gln.py
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu_torch.models import Sandglasset
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import norms
from audio_only_speech_separation_tpu_torch.ops.kernels.global_layer_norm import (
    fused_global_layer_norm,
    global_layer_norm_launches,
    global_layer_norm_ok,
    global_layer_norm_reference,
)
from audio_only_speech_separation_tpu_torch.ops.norms import GlobalLayerNorm, plain_global_layer_norm
from port_bench import harness
from port_bench.bounds import least_time
from port_bench.gln_work import gln_shapes, gln_work
from port_bench.trace import Trace
from torch_port_card import cuda  # noqa: F401 (the fixture)

torch.set_num_threads(2)

CFG = harness.load_json(harness.HERE / "configs" / "sandglasset_wsj0.json")["model_args"]
# six blocks (pools 1, 4, 16, 16, 4, 1 of 32-frame chunks: Q 32, 8, 2, 2, 8, 32)
SMALL = dict(n_feats=16, bn_chan=16, hid_size=8, chunk_size=32, hop_size=16, n_repeats=6, n_head=2,
             sample_rate=8000)


def _rand(shape, seed, dtype=torch.bfloat16, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((offset + scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _norm(C, seed, dtype=torch.bfloat16, channels_last=True):
    m = GlobalLayerNorm(C, eps=1e-5, channels_last=channels_last)
    with torch.no_grad():
        m.weight.copy_(_rand(C, seed, torch.float32, 0.2, 1.0))
        m.bias.copy_(_rand(C, seed + 1, torch.float32, 0.1))
    return m.to(dtype)


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_envelope():
    assert global_layer_norm_ok(8) and global_layer_norm_ok(128) and global_layer_norm_ok(1024)
    assert not global_layer_norm_ok(12) and not global_layer_norm_ok(1032) and not global_layer_norm_ok(0)
    assert not global_layer_norm_ok(33)


@pytest.fixture
def card_forced(monkeypatch):
    """``kernels.kernel_input`` true for any bf16 tensor (as for bf16 on the
    card) and K9's wrapper, as the norm calls it, replaced by a stand-in
    that notes each call and runs the plain version."""
    calls = []

    def stand_in(x, weight, bias, eps, residual=None):
        calls.append((tuple(x.shape), residual is not None))
        return global_layer_norm_reference(x, weight, bias, eps, residual)

    monkeypatch.setattr(kernels, "kernel_input", lambda x: x.dtype == torch.bfloat16)
    monkeypatch.setattr(norms, "fused_global_layer_norm", stand_in)
    return calls


@pytest.mark.parametrize("residual", [False, True])
def test_rule_holds_on_a_channels_last_bf16_input(card_forced, residual):
    """A contiguous bf16 [B, S, K, C] input with bf16 affines and no
    gradient recorded takes the wrapper once, with the residual handed on;
    the result is the plain path's bit for bit."""
    norm = _norm(16, 3)
    x, r = _rand((2, 5, 6, 16), 4), _rand((2, 5, 6, 16), 5)
    r = r if residual else None
    with torch.no_grad():
        assert norm.fuses(x, None, r)
        got = norm(x, residual=r)
    want = plain_global_layer_norm(x, norm.weight, norm.bias, norm.eps, True)
    assert card_forced == [((2, 5, 6, 16), residual)]
    assert _equal(got, want if r is None else r + want)


def _edge(name):
    """(norm, x, group, residual, grad mode) one step outside the rule."""
    norm, x, r, group, grad = _norm(16, 3), _rand((2, 5, 6, 16), 4), _rand((2, 5, 6, 16), 5), None, False
    if name == "channels_first":
        norm = _norm(16, 3, channels_last=False)
        x, r = x.transpose(1, 3).contiguous(), r.transpose(1, 3).contiguous()
    elif name == "float32_input":
        x, r = x.float(), r.float()
    elif name == "non_contiguous_input":
        x = _rand((2, 6, 5, 16), 4).transpose(1, 2)
    elif name == "non_contiguous_residual":
        r = _rand((2, 6, 5, 16), 5).transpose(1, 2)
    elif name == "misaligned_input":
        x = torch.cat([torch.zeros(1, dtype=torch.bfloat16), x.flatten()])[1:].view(x.shape)
    elif name == "residual_of_another_shape":
        r = r[:, :1]
    elif name == "float32_residual":
        r = r.float()
    elif name == "group":
        group = object()
    elif name == "gradient_recorded":
        grad = True
    elif name == "channels_not_a_multiple_of_8":
        norm, x, r = _norm(12, 3), _rand((2, 5, 6, 12), 4), _rand((2, 5, 6, 12), 5)
    elif name == "channels_above_1024":
        norm, x, r = _norm(1032, 3), _rand((1, 3, 1032), 4), _rand((1, 3, 1032), 5)
    elif name == "float32_affines":
        norm = norm.float()
    return norm, x, group, r, grad


EDGES = ["channels_first", "float32_input", "non_contiguous_input", "non_contiguous_residual", "misaligned_input",
         "residual_of_another_shape", "float32_residual", "group", "gradient_recorded",
         "channels_not_a_multiple_of_8", "channels_above_1024", "float32_affines"]


@pytest.mark.parametrize("edge", EDGES)
def test_rule_is_false_at_each_edge(card_forced, edge):
    """One condition of the rule broken at a time: ``fuses`` is false, the
    forward calls no wrapper, and (but for the sequence-parallel group,
    which needs a process group to run) gives ``r + gLN(x)`` of the plain
    path bit for bit."""
    norm, x, group, r, grad = _edge(edge)
    with torch.set_grad_enabled(grad):
        assert not norm.fuses(x, group, r)
        if group is not None:
            return
        got = norm(x, residual=r)
        want = r + plain_global_layer_norm(x, norm.weight, norm.bias, norm.eps, norm.channels_last)
    assert card_forced == []
    assert _equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 5, 6, 16), (3, 7, 8), (1, 4, 1024), (2, 1, 8)])
def test_plain_version_and_residual_are_r_plus_gln(dtype, shape):
    """On the CPU ``global_layer_norm_reference``, ``GlobalLayerNorm(x,
    residual=r)`` and K9's wrapper each equal ``r + GlobalLayerNorm(x)``
    bit for bit, and without a residual ``GlobalLayerNorm(x)``; the input
    is offset from 0, so the shift by the first element matters."""
    norm = _norm(shape[-1], 6, dtype)
    x, r = _rand(shape, 7, dtype, 2.0, 3.0), _rand(shape, 8, dtype)
    with torch.no_grad():
        y = norm(x)
        want = r + y
        assert _equal(global_layer_norm_reference(x, norm.weight, norm.bias, norm.eps, r), want)
        assert _equal(norm(x, residual=r), want)
        assert _equal(fused_global_layer_norm(x, norm.weight, norm.bias, norm.eps, r), want)
        assert _equal(global_layer_norm_reference(x, norm.weight, norm.bias, norm.eps), y)
        assert _equal(fused_global_layer_norm(x, norm.weight, norm.bias, norm.eps), y)


def test_wrapper_refuses_another_device():
    x = _rand((2, 8), 1).to("meta")
    with pytest.raises(ValueError, match="no gLN kernel"):
        fused_global_layer_norm(x, x[0], x[0], 1e-5)


@pytest.mark.parametrize("batch", [2, 3])
def test_sandglasset_takes_k9_at_its_15_glns(card_forced, batch):
    """A bf16 Sandglasset of 6 blocks with the card forced: the wrapper at
    ``enc_LN``, ``seg_norm``, each block's ``intra_norm`` and ``inter_norm``
    (with the block's residual) and ``out_norm``, in that order; the output
    is bit for bit that of the same call with the norms' rule off (K4 and K6
    in their kernel form in both)."""
    m = Sandglasset(**SMALL, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16).eval()
    x = _rand((batch, 1200), 9, torch.bfloat16, 0.05)
    with torch.no_grad():
        got = m(x)
        calls = list(card_forced)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(GlobalLayerNorm, "fuses", lambda *args: False)
            want = m(x)
    B, I, N = batch, 1202, 16  # frames of 1200 samples: window 2, hop 1, padded
    block = (B, (I + 32) // 16 + 1, 32, 16)
    assert calls == [((B, I, N), False), (block, False)] + [(block, True)] * 12 + [((B * 2, I, N), False)]
    assert _equal(got, want)


# ---------------------------------------------------------------------------
# The yardstick: gln_work.py and the two readers
# ---------------------------------------------------------------------------

def test_cell_request_is_15_glns_of_1_563_ms():
    """The cell's 8 x 4.0 s request at 8 kHz: 32,002 frames, 259 chunks of
    250; ``enc_LN`` over [8, 32002, 64], ``seg_norm`` and 12 residual gLNs
    over [8, 259, 250, 128], ``out_norm`` over [16, 32002, 64]; 5.236 GB in
    bf16, 1.563 ms at 3.35 TB/s."""
    sites = gln_shapes(CFG, 8, 32000)
    block = 259 * 250 * 128
    assert sites == [(8, 32002 * 64, False), (8, block, False)] + [(8, block, True)] * 12 + [(16, 32002 * 64, False)]
    nbytes = sum(gln_work(*s)[0] for s in sites)
    assert nbytes == 2 * (8 * 32002 * 64 * 2 + 8 * block * 2 + 12 * 8 * block * 3 + 16 * 32002 * 64 * 2)
    assert nbytes == pytest.approx(5.236e9, rel=1e-3)
    least = sum(least_time(*gln_work(*s))[0] for s in sites)
    assert least * 1e3 == pytest.approx(1.563, abs=0.0005)


def _ctx(device_ops, requests=((32000,) * 8,) * 2):
    tr = Trace(device=[(n, i * 10_000, i * 10_000 + dur) for i, (n, dur) in enumerate(device_ops)])
    cell = SimpleNamespace(cfg={"model_args": CFG})
    return SimpleNamespace(cell=cell, trace=tr, read={"bucket": 8000, "traced": {"requests": list(requests)}})


def _reader(name):
    return harness.load_reader(name).read


def test_readers_on_a_trace_with_k9():
    """Two traced requests, 15 gLNs each, each pass 100 us on the device:
    15.0 gLNs a request, and the least time over 6 ms."""
    ops = [("gln_stats_kernel", 100_000), ("gln_apply_kernel", 100_000)] * 30 + [("attention_kernel", 40_000)] * 12
    ctx = _ctx(ops)
    assert _reader("serve.gln_launches")(ctx) == 15.0
    least = sum(least_time(*gln_work(*s))[0] for s in gln_shapes(CFG, 8, 32000))
    assert _reader("gln_roofline")(ctx) == pytest.approx(100 * 2 * least / (60 * 100e-6))


def test_readers_find_nothing_without_k9():
    """A trace of a program without K9 (torch's elementwise and reduction
    passes): both readers give None, so the result line leaves the metrics
    out."""
    ctx = _ctx([("elementwise_kernel", 90_000)] * 200 + [("reduce_kernel", 40_000)] * 60)
    assert _reader("serve.gln_launches")(ctx) is None
    assert _reader("gln_roofline")(ctx) is None
    assert _reader("gln_roofline")(SimpleNamespace(trace=None)) is None
    assert _reader("serve.gln_launches")(SimpleNamespace(trace=None, read={})) is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_served_sandglasset_runs_15_k9_glns(cuda):
    """The Sandglasset cell's model (its defaults, seeded weights, redrawn
    norms) served through ``Server`` at 8 x 4.0 s: 15 K9 gLNs a request
    (the counter, and 15 of each pass on the device), and the answer within
    the 1.5x rule against the f32 module, the plain bf16 path (the kernels'
    plain versions) as the yardstick."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from port_bench.trace import read
    from torch_port_card import SANDGLASSET, SANDGLASSET_K9, TSR, dualpath_paths, meets_the_rule, seeded_model, waves

    model = seeded_model("Sandglasset", SANDGLASSET, TSR, 92, cuda)
    kernel, plain, f32 = dualpath_paths(model)
    x = waves(cuda, 93, 8, 4 * TSR)
    traces = []
    # a warm-up step traced and dropped before the counted one: a trace's first
    # device operations have been seen missing where the profiler started cold
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda prof: traces.append(read(prof))) as prof:
        kernel(x)
        torch.cuda.synchronize()
        prof.step()
        before = global_layer_norm_launches.launches
        got = kernel(x)
        torch.cuda.synchronize()
        prof.step()
    assert global_layer_norm_launches.launches - before == SANDGLASSET_K9 == 15
    names = [name for name, _, _ in traces[0].device]
    assert names.count("gln_stats_kernel") == names.count("gln_apply_kernel") == 15
    meets_the_rule(got, f32(x), plain(x), "Sandglasset")


@pytest.mark.cuda
def test_tdanet_module_path_takes_k9(cuda):
    """TDANet (tdanet_lrs2) at 2 x 2 s x 16 kHz, the bf16 module path: its
    blocks' channels-last gLNs that meet the rule take K9 (its ``ln`` has 33
    channels, outside the envelope, and keeps the plain path); the output
    within the 1.5x rule against the f32 module, the plain bf16 module as
    the yardstick."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from torch_port_card import SR, TDANET_LRS2, meets_the_rule, seeded_model, waves

    model = seeded_model("TDANet", TDANET_LRS2, SR, 42, cuda)
    assert model.ln.weight.shape == (33,) and not global_layer_norm_ok(33)
    module = copy.deepcopy(model).to(torch.bfloat16)
    x = waves(cuda, 34, 2, 2 * SR)
    with torch.no_grad():
        before = global_layer_norm_launches.launches
        got = module(x.to(torch.bfloat16))
        torch.cuda.synchronize()
        launched = global_layer_norm_launches.launches - before
        with plain_versions():
            plain = module(x.to(torch.bfloat16))
        ref = model(x)
    assert launched > 0
    meets_the_rule(got, ref, plain, "TDANet")
