"""The CUDA kernels (the whole separator K1, the TCN chain's forward K2 and
backward K3, attention K4, the LSTM recurrences K5 and K6, the elementwise
probe K7) against their plain versions, on the card, and K5/K6 inside a
layer trained on bf16 casts of its f32 parameters.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
without one.  This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import contextlib

import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu_torch.models import ConvTasNet
from audio_only_speech_separation_tpu_torch.models.convtasnet import (
    fused_inference_forward,
    inference_frames,
    make_kernel_train_apply,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import (
    fused_tcn_backward,
    tcn_backward_launches,
    tcn_backward_reference,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import (
    convtasnet_separator_launches,
    convtasnet_separator_reference,
    fused_convtasnet_separator,
    fused_tcn_separator,
    pack_convtasnet_full_params,
    tcn_chain_reference,
    tcn_separator_launches,
    tcn_separator_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(cuda, **kw):
    cfg = dict(N=256, H=256, B=128, L=16, X=3, R=1, num_spks=2, sample_rate=8000)
    cfg.update(kw)
    m = ConvTasNet(**cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    rng = np.random.default_rng(1)
    with torch.no_grad():  # random norm affines and slopes, some above 1
        for name, p in m.named_parameters():
            if name.endswith("prelu1.weight") or name.endswith("prelu2.weight"):
                p.fill_(float(rng.uniform(0.05, 1.5)))
            elif "norm" in name or "bottleneck.0" in name:
                p.add_(torch.from_numpy(0.2 * rng.standard_normal(p.shape).astype(np.float32)).to(cuda))
    return m


@pytest.mark.parametrize("act,T", [("relu", 4000), ("sigmoid", 63), ("relu", 1), ("sigmoid", 5001)])
def test_kernel_matches_plain_version(cuda, act, T):
    """Same frames and weights: the kernel against its plain version to
    bf16 output rounding (atol 2e-2 of the frames' scale), bit-identical
    from run to run (no atomics), and the launches the library reports."""
    m = _model(cuda, activate=act)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, max(T, 32))).astype(np.float32)).to(cuda)
    frames = inference_frames(m, x)[:, :T].contiguous()
    *w, dils = pack_convtasnet_full_params(m.state_dict(), m.R, m.X, m.num_spks, device=cuda)
    kw = dict(dilations=dils, nspk=m.num_spks, sigmoid=act == "sigmoid")
    before = fused_convtasnet_separator.launches
    got = fused_convtasnet_separator(frames, *w, **kw)
    again = fused_convtasnet_separator(frames, *w, **kw)
    want = convtasnet_separator_reference(frames, *w, **kw)
    torch.cuda.synchronize()
    assert fused_convtasnet_separator.launches - before == 2 * convtasnet_separator_launches(len(dils))
    assert torch.equal(got, again)
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * max(scale, 1.0)


# K1 at the edges of its tiling: dilations up to 128 with T' = 100 (d > T'),
# B = 1 with T' % 64 != 0, and T' = 1 at full depth of one repeat
SEPARATOR_EDGES = [(8, 2, 100), (3, 1, 333), (8, 1, 1)]  # X, B, T'


@pytest.mark.parametrize("X,B,T", SEPARATOR_EDGES)
def test_separator_kernel_at_the_edges(cuda, X, B, T):
    """As test_kernel_matches_plain_version, where the recomputed taps
    reach past either end of the utterance from every tile."""
    m = _model(cuda, X=X, num_spks=3)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 4 * T + 32)).astype(np.float32)).to(cuda)
    frames = inference_frames(m, x)[:, :T].contiguous()
    *w, dils = pack_convtasnet_full_params(m.state_dict(), m.R, m.X, m.num_spks, device=cuda)
    kw = dict(dilations=dils, nspk=m.num_spks)
    before = fused_convtasnet_separator.launches
    got = fused_convtasnet_separator(frames, *w, **kw)
    again = fused_convtasnet_separator(frames, *w, **kw)
    want = convtasnet_separator_reference(frames, *w, **kw)
    torch.cuda.synchronize()
    assert fused_convtasnet_separator.launches - before == 2 * convtasnet_separator_launches(len(dils))
    assert got.shape == (B, 3, T, 16) and torch.equal(got, again)
    scale = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * max(scale, 1.0)


def test_served_path_meets_the_validator_rule(cuda):
    """End to end against the f32 module: kernel error <= 1.5 * (plain bf16
    error) + 1e-3 (scripts/validate_pallas.py:148)."""
    m = _model(cuda, num_spks=3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 7777)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        ref = m(x)
        got = fused_inference_forward(m, x)
        plain = fused_inference_forward(m, x, separator=convtasnet_separator_reference)
    err = float((got.float() - ref).abs().max())
    plain_err = float((plain.float() - ref).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


# ---------------------------------------------------------------------------
# The TCN chain's forward (K2) and backward (K3) kernels
# ---------------------------------------------------------------------------

CHAIN_CASES = [(2, 128, 2, 200), (4, 256, 2, 301), (3, 512, 1, 4000)]  # nb, H, B, T'
# K3's edges: dilations up to 128 (> a 64-frame tile), T' % 64 != 0, B = 1;
# and the full depth of ConvTasNet-LRS3 (24 blocks, H 512)
BACKWARD_CASES = [(*c, False) for c in CHAIN_CASES] + [(8, 512, 1, 333, False), (9, 256, 3, 130, False),
                                                       (24, 512, 2, 2000, True)]


def _chain_inputs(dev, nb, H, B, T, seed=0):
    """The JAX package's backward-test inputs (tests/test_tcn_backward.py:36)."""
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    x = t(rng.normal(size=(B, T, 128)), bf)
    w1s = t(rng.normal(size=(nb, 128, H)) * 0.1, bf)
    wsgs = t(rng.normal(size=(nb, H, 128)) * 0.1, bf)
    vecs = rng.normal(size=(nb, 8, H)) * 0.3
    vecs[:, 7] = 0.0
    cs = t(rng.normal(size=(nb, 2, 128)) * 0.1)
    alphas = t(np.abs(rng.normal(size=(nb, 2))) * 0.3 + 0.05)
    g = t(rng.normal(size=(B, T, 128)), bf)
    return x, (w1s, wsgs, t(vecs), cs, alphas), tuple(2 ** (i % 8) for i in range(nb)), g


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / (a.norm() + 1e-9))


@pytest.mark.parametrize("nb,H,B,T", CHAIN_CASES)
def test_chain_forward_matches_plain_version(cuda, nb, H, B, T):
    """K2 against its plain version: y and y_hist to bf16 rounding (atol
    5e-2, rtol 2e-2, as the JAX package's kernel-vs-oracle check), stats
    to 1e-3 relative, bit-identical from run to run, y_hist rows >= T'
    zero, and the launches the library reports."""
    x, w, dils, _ = _chain_inputs(cuda, nb, H, B, T)
    before = fused_tcn_separator.launches
    got = fused_tcn_separator(x, *w, dils, save_state=True)
    again = fused_tcn_separator(x, *w, dils, save_state=True)
    want = tcn_separator_reference(x, *w, dils, save_state=True)
    torch.cuda.synchronize()
    assert fused_tcn_separator.launches - before == 2 * tcn_separator_launches(nb)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape and a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), atol=5e-2, rtol=2e-2)
    assert torch.equal(got[1][:, 0, :T], x) and not bool(got[1][:, :, T:].any())
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=0.0)


# K2 at the edges of its tiling: dilations up to 128 with T' = 100 (d > T'),
# T' = 1, B = 1 with T' % 64 != 0, and H 512 at ConvTasNet-LRS3's full depth
CHAIN_EDGES = [(8, 256, 2, 100), (3, 128, 2, 1), (4, 256, 1, 333), (24, 512, 2, 700)]


@pytest.mark.parametrize("nb,H,B,T", CHAIN_EDGES)
def test_chain_forward_at_the_edges(cuda, nb, H, B, T):
    """K2 block by block against the plain block on the kernel's own saved
    input (chip_smoke.py phase 5's gates: each block's output within atol
    5e-2 + rtol 2e-2, its statistics within 1e-3 relative; end to end
    rel-l2 <= 2e-2, which bounds the bf16 drift over the depth),
    bit-identical from run to run, y_hist slot 0 = x, rows >= T' zero."""
    x, w, dils, _ = _chain_inputs(cuda, nb, H, B, T)
    before = fused_tcn_separator.launches
    y, hist, st = fused_tcn_separator(x, *w, dils, save_state=True)
    again = fused_tcn_separator(x, *w, dils, save_state=True)
    torch.cuda.synchronize()
    assert fused_tcn_separator.launches - before == 2 * tcn_separator_launches(nb)
    for a, b in zip((y, hist, st), again):
        assert torch.equal(a, b) and bool(torch.isfinite(a.float()).all())
    assert torch.equal(hist[:, 0, :T], x) and not bool(hist[:, :, T:].any())
    for b in range(nb):
        one = [t[b : b + 1] for t in w]
        y_b, _, st_b = tcn_separator_reference(hist[:, b, :T], *one, dils[b : b + 1], save_state=True)
        out = hist[:, b + 1, :T] if b + 1 < nb else y
        torch.testing.assert_close(out.float(), y_b.float(), atol=5e-2, rtol=2e-2)
        torch.testing.assert_close(st[:, b], st_b[:, 0], rtol=1e-3, atol=0.0)
    assert _rel(tcn_separator_reference(x, *w, dils), y) <= 2e-2


@pytest.mark.parametrize("nb,H,B,T,full", BACKWARD_CASES)
def test_chain_backward_matches_plain_version(cuda, nb, H, B, T, full):
    """K3 against autograd of the plain chain on the same saved state:
    rel-l2 < 6e-2 for each of the six cotangents, dalphas included (the
    JAX validator allows 0.5 there; the small cases hold the tight bound,
    the full-depth case the validator's 0.5 with the sign of the sum),
    dvecs row 7 exactly zero, bit-identical from run to run, and the
    launches the library reports."""
    x, w, dils, g = _chain_inputs(cuda, nb, H, B, T)
    y, y_hist, stats = fused_tcn_separator(x, *w, dils, save_state=True)
    before = fused_tcn_backward.launches
    got = fused_tcn_backward(g, y_hist, y, stats, *w, dils)
    again = fused_tcn_backward(g, y_hist, y, stats, *w, dils)
    want = tcn_backward_reference(g, y_hist, y, stats, *w, dils)
    torch.cuda.synchronize()
    assert fused_tcn_backward.launches - before == 2 * tcn_backward_launches(nb)
    for name, a, b, c in zip(("dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas"), got, again, want):
        assert torch.equal(a, b), name
        assert a.shape == c.shape and bool(torch.isfinite(a.float()).all()), name
        if full and name == "dalphas":
            assert _rel(c, a) <= 0.5 and float(a.sum()) * float(c.sum()) > 0, (name, _rel(c, a))
        else:
            assert _rel(c, a) < 6e-2, (name, _rel(c, a))
    assert bool((got[3][:, 7] == 0).all())


def test_train_step_through_the_kernels(cuda):
    """make_kernel_train_apply with the kernels against the same path with
    the plain chain: loss within 5e-3 and every parameter gradient within
    rel-l2 0.1 (the JAX package's kernel-vs-delayed bound,
    tests/test_tcn_backward.py:149-176; the scalar PReLU slopes get the
    sign and 0.5 there)."""
    m = _model(cuda, N=256, H=256, X=3, R=1, num_spks=2)
    params = {k: p for k, p in m.named_parameters()}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 6400)).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy(rng.standard_normal((2, 2, 6400)).astype(np.float32)).to(cuda)

    def loss_and_grads(fn):
        pb = {k: v.to(torch.bfloat16) for k, v in params.items()}
        loss = (fn(pb, x.to(torch.bfloat16)).float() - tgt).square().mean()
        return float(loss.detach()), torch.autograd.grad(loss, list(params.values()))

    lk, gk = loss_and_grads(make_kernel_train_apply(m))
    lp, gp = loss_and_grads(make_kernel_train_apply(m, chain=tcn_chain_reference))
    assert abs(lk - lp) < 5e-3 * max(1.0, abs(lp)), (lk, lp)
    for name, a, b in zip(params, gp, gk):
        assert bool(torch.isfinite(b).all()), name
        if a.numel() <= 2:
            assert float(a.sum()) * float(b.sum()) > 0 and _rel(a, b) < 0.5, name
        else:
            assert _rel(a, b) < 0.1, (name, _rel(a, b))


# ---------------------------------------------------------------------------
# The dual-path kernels: attention (K4) and the LSTM recurrences (K5, K6)
# ---------------------------------------------------------------------------

from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (  # noqa: E402
    attention_bdt_reference,
    attention_packed_reference,
    fused_attention_bdt,
    fused_attention_packed,
    k4_launches,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (  # noqa: E402
    bilstm_reference,
    fused_bilstm,
    recurrence_cluster,
    resident_bilstm,
    resident_bilstm_reference,
    resident_cluster,
    resident_launches,
)


def _bf16(dev, a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)


# the JAX validator's shapes (scripts/validate_pallas.py:183), DPTNet's rows
# and columns, and edge cases: dh not a multiple of 16, T = 1, a ragged tile;
# T on either side of a 16-query tile, the batch-1 12 s rows (T 242: two
# query blocks, two key chunks), several key chunks at dh 16, dh 8 and 256;
# Sepformer's intra and inter passes at B=2 x 2 s x 16 kHz; Sandglasset's
# three attentions at B=8 x 2 s x 8 kHz (S = 131 chunks, 8 heads of 16, K 250
# positions batched in blocks 0 and 5, 62 pooled in blocks 1 and 4, 15 in 2
# and 3); DPTNet's rows with group size 2 (dh 8); the wsj0 TasNet DPTNet
# core with group size 2 at B=8 x 2 s x 8 kHz (rows: 8 x 2 x 6 chunks of 100
# frames; columns: 8 x 2 x 100 sequences of 6 chunks; 4 heads of dh 8)
ATTN_CASES = [(512, 32, 250), (16, 64, 129), (1344, 16, 100), (3200, 16, 42),
              (3, 8, 1), (5, 24, 77), (2, 256, 300), (3, 16, 15), (3, 16, 16), (3, 16, 17),
              (400, 16, 242), (4, 16, 300), (6, 8, 50), (3, 256, 40),
              (544, 32, 250), (4000, 32, 34), (16000, 16, 131), (3968, 16, 131), (960, 16, 131),
              (64, 8, 100), (384, 8, 100), (6400, 8, 6)]


@pytest.mark.parametrize("BH,dh,T", ATTN_CASES)
def test_attention_matches_plain_version(cuda, BH, dh, T):
    """K4 against its plain version on unit-normal q, k, v: bf16 max abs
    < 2e-2 (the validator's bound), one launch a call, bit-identical runs."""
    rng = np.random.default_rng(BH + dh + T)
    q, k, v = (_bf16(cuda, rng.standard_normal((BH, dh, T))) for _ in range(3))
    before = fused_attention_bdt.launches
    got = fused_attention_bdt(q, k, v)
    again = fused_attention_bdt(q, k, v)
    want = attention_bdt_reference(q, k, v)
    torch.cuda.synchronize()
    assert fused_attention_bdt.launches - before == 2
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) < 2e-2


# (B, T, heads, dh) of the packed entry: Sepformer's intra and inter passes
# in the served cell (8 x 2 s x 16 kHz: 272 sequences of 250 chunks' frames,
# 2000 of 34 chunks; 8 heads of 32), DPTNet's rows and columns at B=8 x 2 s
# x 8 kHz (336 of 100, 800 of 42; 4 heads of 16), T 13 and T 1, two key
# chunks at dh 8, one head of 256, and T 129 (a second query block of one
# token)
PACKED_CASES = [(272, 250, 8, 32), (2000, 34, 8, 32), (336, 100, 4, 16), (800, 42, 4, 16),
                (5, 13, 3, 64), (7, 1, 2, 32), (3, 300, 2, 8), (2, 40, 1, 256), (4, 129, 2, 24)]


@pytest.mark.parametrize("B,T,heads,dh", PACKED_CASES)
def test_packed_attention_matches_plain_version(cuda, B, T, heads, dh):
    """K4's packed entry against its plain version on a unit-normal
    [B, T, 3E] in-projection: bf16 max abs < 2e-2 (the validator's bound),
    one launch a call and none of the [B*h, dh, T] entry's, bit-identical
    runs, the output a contiguous [B, T, E]."""
    qkv = _bf16(cuda, np.random.default_rng(B + T + dh).standard_normal((B, T, 3 * heads * dh)))
    before, before_bdt = fused_attention_packed.launches, fused_attention_bdt.launches
    got = fused_attention_packed(qkv, heads)
    again = fused_attention_packed(qkv, heads)
    want = attention_packed_reference(qkv, heads)
    torch.cuda.synchronize()
    assert fused_attention_packed.launches - before == 2 and fused_attention_bdt.launches == before_bdt
    assert got.shape == (B, T, heads * dh) and got.is_contiguous() and torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) < 2e-2


def test_packed_attention_refuses_what_the_kernel_does_not_take(cuda):
    """On the card the packed entry raises on float32, on a ``qkv`` not on
    a 16-byte boundary and outside the envelope, and launches nothing."""
    qkv = _bf16(cuda, np.zeros((2, 5, 3 * 2 * 16)))
    shifted = torch.zeros(1 + qkv.numel(), device=cuda, dtype=torch.bfloat16)[1:].view(qkv.shape)
    before = fused_attention_packed.launches
    with pytest.raises(ValueError, match="bfloat16"):
        fused_attention_packed(qkv.float(), 2)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_attention_packed(shifted, 2)
    with pytest.raises(ValueError, match="dh % 8 == 0"):
        fused_attention_packed(qkv, 8)  # 8 heads of dh 4
    assert fused_attention_packed.launches == before


# (T, D, B, H): the validator's (scripts/validate_pallas.py:283), the batch-1
# inter-chunk pass, and a small odd batch; T = 1, a partial 16-row tile
# (B 17), 100 sequences at H 128 with a short T, H 48 (a cluster of 2) and
# H 256 at B 2; batches too large for a cluster (one block a tile), where
# the xw ring is 4H wide and W_hh (H 256) is read from L2; BSRNN's band RNNs
# at B=1 and 4 x 4 s x 8 kHz (8 bands of 501 frames, H 256); DPRNNTasNet's
# rows (128 chunks of 32 frames) and columns (32 sequences of 128 chunks) at
# B=1 x 2 s x 8 kHz (H 256); the wsj0 TasNet DPRNN and DPTNet cores' rows with
# group size 2 at B=8 x 2 s x 8 kHz (8 x 2 x 6 chunks of 100 frames, H 64)
BILSTM_CASES = [(251, 2, 64, 256), (250, 2, 96, 128), (128, 1, 32, 128), (242, 2, 100, 128),
                (9, 2, 3, 16), (1, 2, 4, 32), (6, 2, 17, 16), (5, 2, 100, 128), (40, 2, 3, 48),
                (4, 1, 2, 256), (3, 2, 1100, 128), (3, 2, 1100, 256), (501, 2, 8, 256), (501, 2, 32, 256),
                (32, 2, 128, 256), (128, 2, 32, 256), (100, 2, 96, 64)]


@pytest.mark.parametrize("T,D,B,H", BILSTM_CASES)
def test_bilstm_recurrence_matches_plain_version(cuda, T, D, B, H):
    """K5 against its plain version on the validator's inputs (xw * 0.3,
    w_hh * 0.05): max abs < 1e-2, bit-identical from run to run, one
    launch a call."""
    rng = np.random.default_rng(T + B)
    xw = _bf16(cuda, rng.standard_normal((T, D, B, 4 * H)) * 0.3)
    whh = _bf16(cuda, rng.standard_normal((D, H, 4 * H)) * 0.05)
    before = fused_bilstm.launches
    got = fused_bilstm(xw, whh)
    again = fused_bilstm(xw, whh)
    want = bilstm_reference(xw, whh)
    torch.cuda.synchronize()
    assert fused_bilstm.launches - before == 2
    assert got.shape == (T, D, B, H)
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) < 1e-2


def test_recurrence_cases_cover_each_cluster_plan(cuda):
    """K5 runs K6's step: a cluster of 4 (H 128 at a small batch), 2 (H 48,
    whose 12 gate pairs do not split four ways) and 1 (too many tiles for
    the card at once) are all among the cases above."""
    plans = {recurrence_cluster(B, D, H) for _, D, B, H in BILSTM_CASES}
    assert plans == {1, 2, 4}, plans


# (T, B, Din, H, D, bias): the validator's (scripts/validate_pallas.py:246)
# at this model's chunk counts, an odd batch, no bias; a batch within one
# 16-row tile, T = 1, H 16 (two warps a block), H 256 / Din 128; and
# batches too large for a cluster (one block a tile), where W_hh (H 256) or
# W_ih (Din 128, H 128) does not fit in shared memory and is read from L2;
# BSRNN's band-comm RNNs at B=1 and 4 x 4 s x 8 kHz (501 B sequences of 8
# bands, Din 128, H 256); Sandglasset's intra BiLSTM at B=8 and 1 x 2 s x 8
# kHz (131 chunks of 250 frames an utterance, Din 128, H 128: 1048 = 65
# tiles of 16 and 8 rows); DPRNNTasNet's rows (1024 chunks of 32 frames) and
# columns (256 sequences of 128 chunks) at B=8 x 2 s x 8 kHz (H 256); the
# wsj0 TasNet with group size 2 at B=8 x 2 s x 8 kHz: the context GC_RNNs
# (8 x 168 windows of 24 frames x 2 groups, Din 32, H 64) and the grouped
# cores' columns (8 x 2 x 100 sequences of 6 chunks)
RESIDENT_CASES = [(100, 336, 64, 128, 2, True), (42, 800, 64, 128, 2, True), (42, 800, 64, 128, 1, True),
                  (100, 241, 64, 128, 2, True), (250, 256, 128, 128, 2, True),
                  (7, 19, 32, 32, 2, False), (30, 16, 64, 128, 2, True), (1, 40, 64, 128, 2, True),
                  (12, 5, 16, 16, 1, True), (20, 50, 128, 256, 2, True), (9, 33, 64, 256, 1, False),
                  (3, 1100, 64, 256, 2, True), (3, 2200, 128, 128, 1, True),
                  (8, 501, 128, 256, 2, True), (8, 2004, 128, 256, 2, True),
                  (250, 1048, 128, 128, 2, True), (250, 131, 128, 128, 2, True),
                  (32, 1024, 128, 256, 2, True), (128, 256, 128, 256, 2, True),
                  (24, 2688, 32, 64, 2, True), (6, 1600, 32, 64, 2, True)]


@pytest.mark.parametrize("T,B,Din,H,D,with_bias", RESIDENT_CASES)
def test_resident_bilstm_matches_plain_version(cuda, T, B, Din, H, D, with_bias):
    """K6 against its plain version on the validator's inputs (x * 0.5,
    w_ih * 0.08, w_hh * 0.05, bias * 0.05): max abs < 1e-2, bit-identical
    from run to run, the launches the library reports."""
    rng = np.random.default_rng(T + B + Din)
    x = _bf16(cuda, rng.standard_normal((B, T, Din)) * 0.5)
    wih = _bf16(cuda, rng.standard_normal((D, Din, 4 * H)) * 0.08)
    whh = _bf16(cuda, rng.standard_normal((D, H, 4 * H)) * 0.05)
    bias = (torch.from_numpy((rng.standard_normal((D, 4 * H)) * 0.05).astype(np.float32)).to(cuda)
            if with_bias else None)
    before = resident_bilstm.launches
    got = resident_bilstm(x, wih, whh, bias)
    again = resident_bilstm(x, wih, whh, bias)
    want = resident_bilstm_reference(x, wih, whh, bias)
    torch.cuda.synchronize()
    assert resident_bilstm.launches - before == 2 * resident_launches()
    assert got.shape == (T, D, B, H)
    assert torch.equal(got, again)
    assert float((got.float() - want.float()).abs().max()) < 1e-2


def test_resident_cases_cover_each_cluster_plan(cuda):
    """K6 spreads a step over a cluster of 1, 2 or 4 thread blocks, as
    many as fit on the card at once; the cases above take more than one
    plan, so both the distributed-shared-memory exchange and the
    single-block step are checked."""
    plans = {resident_cluster(B, D, Din, H) for _, B, Din, H, D, _ in RESIDENT_CASES}
    assert plans <= {1, 2, 4} and len(plans) >= 2, plans


def test_dualpath_kernel_backward_matches_plain_autograd(cuda):
    """Each wrapper's backward (autograd through its plain version) against
    autograd of the plain version: rel-l2 < 2e-2 for every input."""
    rng = np.random.default_rng(7)

    def check(kernel, plain, *inputs):
        leaves = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
        ref = [t.clone().requires_grad_(t.is_floating_point()) for t in inputs]
        out_k, out_p = kernel(*leaves), plain(*ref)
        g = torch.from_numpy(rng.standard_normal(out_p.shape).astype(np.float32)).to(cuda, out_p.dtype)
        gk = torch.autograd.grad(out_k, leaves, g)
        gp = torch.autograd.grad(out_p, ref, g)
        for a, b in zip(gp, gk):
            assert _rel(a, b) < 2e-2

    q, k, v = (_bf16(cuda, rng.standard_normal((6, 16, 37))) for _ in range(3))
    check(fused_attention_bdt, attention_bdt_reference, q, k, v)
    check(lambda a: fused_attention_packed(a, 3), lambda a: attention_packed_reference(a, 3),
          _bf16(cuda, rng.standard_normal((4, 37, 3 * 3 * 16))))
    xw = _bf16(cuda, rng.standard_normal((11, 2, 5, 64)) * 0.3)
    whh = _bf16(cuda, rng.standard_normal((2, 16, 64)) * 0.05)
    check(fused_bilstm, bilstm_reference, xw, whh)
    x = _bf16(cuda, rng.standard_normal((140, 9, 16)) * 0.5)
    wih = _bf16(cuda, rng.standard_normal((2, 16, 64)) * 0.08)
    bias = torch.from_numpy((rng.standard_normal((2, 64)) * 0.05).astype(np.float32)).to(cuda)
    check(resident_bilstm, resident_bilstm_reference, x, wih, whh, bias)


@pytest.mark.parametrize("module", ["DPRNN", "DPTNet"])
@pytest.mark.parametrize("batch", [1, 6])
def test_tasnet_kernel_path_meets_the_validator_rule(cuda, module, batch):
    """A small TasNet cast to bf16 on the card runs its LSTMs (and DPTNet
    its attention) through the kernels (1.5 s: 62 chunks of 50 frames, so
    batch 1 gives 62 and 50 sequences, batch 6 372 and 300, all K6: the
    input is 64 wide) and stays within 1.5 * (plain bf16 error) + 1e-3 of
    the f32 module."""
    import copy

    from audio_only_speech_separation_tpu_torch.models import TasNet
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions

    m = TasNet(enc_dim=64, bn_dim=64, hidden_dim=128, layer=2, module=module, block_size=50,
               sample_rate=8000, generator=torch.Generator().manual_seed(3)).to(cuda).eval()
    mk = copy.deepcopy(m).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((batch, 12000)).astype(np.float32)).to(cuda)
    counters = (k4_launches, fused_bilstm, resident_bilstm)
    before = [c.launches for c in counters]
    with torch.no_grad():
        ref = m(x)
        got = mk(x.to(torch.bfloat16))
        with plain_versions():
            plain = mk(x.to(torch.bfloat16))
    torch.cuda.synchronize()
    n4, n5, n6 = (c.launches - b for c, b in zip(counters, before))
    assert (n4 > 0) == (module == "DPTNet")
    assert n5 == 0 and n6 > 0
    err, plain_err = float((got.float() - ref).abs().max()), float((plain.float() - ref).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


# ---------------------------------------------------------------------------
# Sepformer through K4, and the eval CLI on the card
# ---------------------------------------------------------------------------

from audio_only_speech_separation_tpu_torch.models import Sepformer  # noqa: E402

# N 64, 2 heads of dh 32, chunks of 50 frames, 2 intra and 2 inter layers
SMALL_SEPFORMER = dict(encoder_out_nchannels=64, masknet_chunksize=50, masknet_numlayers=2,
                       intra_numlayers=2, inter_numlayers=2, intra_nhead=2, inter_nhead=2,
                       intra_dffn=128, inter_dffn=128, sample_rate=8000)


def test_sepformer_kernel_path_meets_the_validator_rule(cuda):
    """A small Sepformer cast to bf16 on the card, in eval mode, runs every
    attention through K4's packed entry (2 dual blocks x (2 + 2) a call;
    none through the [B*h, dh, T] one) and stays within 1.5 * (plain bf16
    error) + 1e-3 of the f32 module."""
    import copy

    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions

    m = Sepformer(**SMALL_SEPFORMER, generator=torch.Generator().manual_seed(4)).to(cuda).eval()
    mk = copy.deepcopy(m).to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 12000)).astype(np.float32)).to(cuda)
    before, before_bdt = fused_attention_packed.launches, fused_attention_bdt.launches
    with torch.no_grad():
        ref = m(x)
        got = mk(x.to(torch.bfloat16))
        with plain_versions():
            plain = mk(x.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert fused_attention_packed.launches - before == 2 * (2 + 2)
    assert fused_attention_bdt.launches == before_bdt
    assert got.shape == ref.shape and bool(torch.isfinite(got.float()).all())
    err, plain_err = float((got.float() - ref).abs().max()), float((plain.float() - ref).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)


def test_served_sepformer_base_launches_the_packed_entry(cuda):
    """sepformer_base (the served cell's configuration) through ``Server``'s
    "kernels" dispatch at B=2 x 2 s x 16 kHz: K4's packed entry 32 times a
    call (2 dual blocks x (8 intra + 8 inter)), its [B*h, dh, T] entry
    never, and a finite output of the f32 module's shape."""
    import json
    from pathlib import Path

    from audio_only_speech_separation_tpu_torch.serve import Server

    cfg = json.loads((Path(__file__).resolve().parents[1] / "port_bench/configs/sepformer_base.json").read_text())
    m = Sepformer(**cfg["model_args"], sample_rate=cfg["sample_rate"],
                  generator=torch.Generator().manual_seed(5)).to(cuda).eval()
    server = Server(m, True, cuda)
    assert server.dispatch == "kernels"
    x = _waves(cuda, 9, 2, 2 * cfg["sample_rate"])
    server.forward(x)
    torch.cuda.synchronize()
    before, before_bdt = fused_attention_packed.launches, fused_attention_bdt.launches
    out = server.forward(x)
    torch.cuda.synchronize()
    assert fused_attention_packed.launches - before == 32 and fused_attention_bdt.launches == before_bdt
    assert out.shape == (2, 2, x.shape[1]) and bool(torch.isfinite(out.float()).all())


def test_eval_cli_on_the_card(cuda, tmp_path):
    """``audio_test.main`` with ``device="cuda"`` and ``--bf16`` on a tiny
    Sepformer experiment: the "kernels" dispatch (K4 launches), one CSV row
    per utterance plus avg and std, every value finite."""
    import csv
    import json

    from audio_only_speech_separation_tpu_torch import audio_test
    from audio_only_speech_separation_tpu_torch.data.audio_io import write_wav
    from audio_only_speech_separation_tpu_torch.models import save_serialized, serialize

    rng = np.random.default_rng(9)
    lengths = (9000, 4000, 6500)
    for split in ("tr", "cv", "tt"):
        infos = {c: [] for c in ("mix", "s1", "s2")}
        for c in infos:
            (tmp_path / split / c).mkdir(parents=True)
        for i, n in enumerate(lengths):
            s = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
            for c, wav in zip(infos, (s.sum(0), s[0], s[1])):
                path = str(tmp_path / split / c / f"u{i}.wav")
                write_wav(path, wav, 8000)
                infos[c].append([path, n])
        for c, lst in infos.items():
            (tmp_path / split / f"{c}.json").write_text(json.dumps(lst))
    exp = tmp_path / "exp"
    exp.mkdir()
    save_serialized(serialize(Sepformer(**SMALL_SEPFORMER)), str(exp / "best_model.pth"))
    config = {
        "audionet": {"audionet_name": "Sepformer", "audionet_config": {}},
        "datamodule": {"data_name": "LRS2DataModule", "data_config": dict(
            train_dir=str(tmp_path / "tr"), valid_dir=str(tmp_path / "cv"), test_dir=str(tmp_path / "tt"),
            n_src=2, sample_rate=8000, segment=0.5)},
        "main_args": {"exp_dir": str(exp), "bf16": True},
    }
    before = fused_attention_packed.launches
    path = audio_test.main(config, device="cuda")
    assert fused_attention_packed.launches - before == len(lengths) * 2 * (2 + 2)
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i"]
    assert sorted(r[0] for r in rows[1:-2]) == [f"u{i}.wav" for i in range(len(lengths))]
    assert [r[0] for r in rows[-2:]] == ["avg", "std"]
    assert all(np.isfinite(float(v)) for r in rows[1:] for v in r[1:])


# ---------------------------------------------------------------------------
# BSRNN through K5 and K6, TDANet's module path through K4, AFRCNN
# ---------------------------------------------------------------------------


def _validator_rule(m, x, counters):
    """``m`` cast to bf16 on the card against the f32 module: within 1.5 *
    (plain bf16 error) + 1e-3; returns the launches of ``counters``."""
    import copy

    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions

    mk = copy.deepcopy(m).to(torch.bfloat16)
    before = [c.launches for c in counters]
    with torch.no_grad():
        ref = m(x)
        got = mk(x.to(torch.bfloat16))
        launched = [c.launches - b for c, b in zip(counters, before)]
        with plain_versions():
            plain = mk(x.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert got.shape == ref.shape and bool(torch.isfinite(got.float()).all())
    err, plain_err = float((got.float() - ref).abs().max()), float((plain.float() - ref).abs().max())
    assert err <= 1.5 * plain_err + 1e-3, (err, plain_err)
    return launched


def _waves(cuda, seed, B, T):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((B, T)).astype(np.float32)).to(cuda)


def test_bsrnn_kernel_path_meets_the_validator_rule(cuda):
    """A BSRNN (feature 128, H 256, 2 repeats, 8 kHz) at B=2 x 1 s: each
    band RNN (16 sequences of 126 frames, 128 wide) takes K5 and each
    band-comm RNN (252 sequences) K6, once a repeat, within the 1.5x rule
    of the f32 module."""
    from audio_only_speech_separation_tpu_torch.models import BSRNN

    m = BSRNN(feature_dim=128, num_repeat=2, sample_rate=8000,
              generator=torch.Generator().manual_seed(11)).to(cuda).eval()
    launched = _validator_rule(m, _waves(cuda, 12, 2, 8000), (k4_launches, fused_bilstm, resident_bilstm))
    assert launched == [0, 2, 2]


def test_tdanet_module_path_meets_the_validator_rule(cuda):
    """A TDANet (out 32, in 128: 8 heads of dh 16; 3 blocks, depth 3) at
    B=2 x 0.5 s x 16 kHz: the module path runs each block's attention
    through K4, within the 1.5x rule of the f32 module."""
    from audio_only_speech_separation_tpu_torch.models import TDANet

    m = TDANet(out_channels=32, in_channels=128, num_blocks=3, upsampling_depth=3, enc_kernel_size=4,
               generator=torch.Generator().manual_seed(13)).to(cuda).eval()
    launched = _validator_rule(m, _waves(cuda, 14, 2, 8000), (k4_launches, fused_bilstm, resident_bilstm))
    assert launched == [3, 0, 0]


def test_afrcnn_bf16_module_meets_the_validator_rule(cuda):
    """An AFRCNN (out 64, in 128, 3 blocks, depth 4) at B=1 x 0.5 s x 16
    kHz cast to bf16: no kernel, within the 1.5x rule of the f32 module."""
    from audio_only_speech_separation_tpu_torch.models import AFRCNN

    m = AFRCNN(out_channels=64, in_channels=128, num_blocks=3, upsampling_depth=4,
               generator=torch.Generator().manual_seed(15)).to(cuda).eval()
    launched = _validator_rule(m, _waves(cuda, 16, 1, 8000), (k4_launches, fused_bilstm, resident_bilstm))
    assert launched == [0, 0, 0]


from audio_only_speech_separation_tpu_torch.ops.kernels.micro_vpu import (  # noqa: E402
    micro_vpu,
    micro_vpu_reference,
)


@pytest.mark.parametrize("with_stats", [False, True], ids=["plain", "stats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2048, 512), (3, 40)], ids=["script", "odd"])
def test_micro_vpu_matches_plain_version(cuda, shape, dtype, with_stats):
    """K7 against its plain version on the script's input: f32 within 1e-5
    of the output's magnitude (the kernel fuses each multiply-add), bf16
    exactly (a is 1 in bf16, so both round x + b once a step); with stats
    the sum of squares within 1e-5 relative (another summation order);
    bit-identical runs (no atomics); one launch a call, with or without
    stats (one cooperative grid)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32)).to(cuda, dtype)
    before = micro_vpu.launches
    got, total = micro_vpu(x, with_stats, return_stats=True)
    again = micro_vpu(x, with_stats)
    want, want_total = micro_vpu_reference(x, with_stats, return_stats=True)
    torch.cuda.synchronize()
    assert micro_vpu.launches - before == 2
    assert got.dtype == dtype and torch.equal(got, again)
    err = float((got.float() - want.float()).abs().max())
    assert err <= (1e-5 * float(want.float().abs().max()) if dtype == torch.float32 else 0.0)
    if with_stats:
        assert abs(float(total) - float(want_total)) <= 1e-5 * float(want_total)


@pytest.mark.parametrize("T", [4001, 8003])
def test_chain_kernels_do_not_read_unwritten_memory(cuda, T, monkeypatch):
    """K2 (with its saved state) and K3 at the chain's full width and depth
    give the same results, bit for bit, whatever their outputs and scratch
    (``torch.empty``) held before: zeros, 0x7f bytes (3.4e38) or NaN bytes.
    A kernel that read memory it had not written would take its result
    from the allocator's history."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_backward as kb
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_block as kf

    rng = np.random.default_rng(3)
    nb, H = 24, 512

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype)

    x = t(rng.normal(size=(4, T, 128)), torch.bfloat16)
    vecs = rng.normal(size=(nb, 8, H)) * 0.3
    vecs[:, 7] = 0.0
    w = (t(rng.normal(size=(nb, 128, H)) * 0.1, torch.bfloat16), t(rng.normal(size=(nb, H, 128)) * 0.1, torch.bfloat16),
         t(vecs), t(rng.normal(size=(nb, 2, 128)) * 0.1), t(np.abs(rng.normal(size=(nb, 2))) * 0.3 + 0.05))
    g = t(rng.normal(size=(4, T, 128)), torch.bfloat16)
    dils = tuple(2 ** (i % 8) for i in range(nb))
    real_empty = torch.empty
    results = []
    for fill in (0x00, 0x7F, 0xFF):
        def filled(*size, dtype=None, device=None, **kw):
            out = real_empty(*size, dtype=dtype, device=device, **kw)
            out.view(torch.uint8).fill_(fill)
            return out

        monkeypatch.setattr(kf.torch, "empty", filled)
        monkeypatch.setattr(kb.torch, "empty", filled)
        with torch.no_grad():
            y, y_hist, stats = kf.fused_tcn_separator(x, *w, dils, save_state=True)
            grads = kb.fused_tcn_backward(g, y_hist, y, stats, *w, dils)
        monkeypatch.setattr(kf.torch, "empty", real_empty)
        monkeypatch.setattr(kb.torch, "empty", real_empty)
        torch.cuda.synchronize()
        results.append((y, y_hist, stats, *grads))
    names = ("y", "y_hist", "stats", "dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas")
    for i, n in enumerate(names):
        for other in results[1:]:
            assert torch.equal(results[0][i], other[i]), n


@pytest.mark.parametrize("T", [4001, 8003])
def test_chain_kernels_write_only_their_own_memory(cuda, T, monkeypatch):
    """K2 (with its saved state) and K3 at the chain's full width and depth
    write inside their outputs and scratch only: every buffer the wrappers
    allocate, and every input, sits between two 1 MiB guard regions of a
    known byte, which must come out unchanged."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_backward as kb
    from audio_only_speech_separation_tpu_torch.ops.kernels import convtasnet_block as kf

    guard, pattern = 1 << 20, 0xA5
    buffers = []
    full = torch.full  # the wrappers' torch.empty and torch.zeros are replaced below

    def guarded(shape, dtype):
        numel = int(np.prod(shape))
        nbytes = numel * torch.finfo(dtype).bits // 8 if dtype.is_floating_point else numel
        raw = full((2 * guard + nbytes,), pattern, dtype=torch.uint8, device=cuda)
        buffers.append((raw, nbytes))
        return raw[guard:guard + nbytes].view(dtype).view(shape)

    def alloc(fill):
        def make(*size, dtype=None, device=None, **kw):
            shape = tuple(size[0]) if len(size) == 1 and isinstance(size[0], (tuple, list)) else size
            out = guarded(shape, dtype or torch.float32)
            out.fill_(fill) if fill is not None else out.view(torch.uint8).fill_(0)
            return out
        return make

    rng = np.random.default_rng(4)
    nb, H = 24, 512

    def t(a, dtype=torch.float32):
        out = guarded(np.shape(a), dtype)
        out.copy_(torch.from_numpy(np.asarray(a, np.float32)).to(cuda, dtype))
        return out

    x = t(rng.normal(size=(4, T, 128)), torch.bfloat16)
    vecs = rng.normal(size=(nb, 8, H)) * 0.3
    vecs[:, 7] = 0.0
    w = (t(rng.normal(size=(nb, 128, H)) * 0.1, torch.bfloat16), t(rng.normal(size=(nb, H, 128)) * 0.1, torch.bfloat16),
         t(vecs), t(rng.normal(size=(nb, 2, 128)) * 0.1), t(np.abs(rng.normal(size=(nb, 2))) * 0.3 + 0.05))
    g = t(rng.normal(size=(4, T, 128)), torch.bfloat16)
    dils = tuple(2 ** (i % 8) for i in range(nb))
    for module in (kf, kb):
        monkeypatch.setattr(module.torch, "empty", alloc(None))
        monkeypatch.setattr(module.torch, "zeros", alloc(0))
    with torch.no_grad():
        y, y_hist, stats = kf.fused_tcn_separator(x, *w, dils, save_state=True)
        kb.fused_tcn_backward(g, y_hist, y, stats, *w, dils)
    torch.cuda.synchronize()
    for i, (raw, nbytes) in enumerate(buffers):
        head, tail = raw[:guard], raw[guard + nbytes:]
        assert bool((head == pattern).all()) and bool((tail == pattern).all()), (i, nbytes)


@pytest.mark.parametrize("case", ["max", "zero"])
def test_micro_vpu_select_forms(cuda, case):
    """K7's max select (a < 1; the script's a takes min) against the plain
    version's where, bf16 exactly and f32 within 1e-5 of the output's
    magnitude, with and without stats: a 0.75 (the chain settles on 2) and
    a 0 (every step gives b).  The sum of squares is held within 600 *
    2**-24 relative: a thread adds its 64 steps x 8 squares in order in f32
    and the plain version its 64 step sums, and a chain settling on a
    constant nears that worst case, since every addition then rounds the
    same way (the script's input is held within 1e-5 in
    ``test_micro_vpu_matches_plain_version``)."""
    a, b = {"max": (0.75, 0.5), "zero": (0.0, 0.999)}[case]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(np.random.default_rng(1).normal(size=(2048, 512)).astype(np.float32)).to(cuda, dtype)
        for with_stats in (False, True):
            got, total = micro_vpu(x, with_stats, return_stats=True, a=a, b=b)
            want, want_total = micro_vpu_reference(x, with_stats, return_stats=True, a=a, b=b)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            assert err <= (1e-5 * float(want.float().abs().max()) if dtype == torch.float32 else 0.0), with_stats
            if with_stats:
                assert abs(float(total) - float(want_total)) <= 600 * 2.0**-24 * float(want_total)


@pytest.mark.parametrize("name", ["rmsprop", "adagrad", "lamb", "novograd", "yogi", "lars", "sm3", "adafactor",
                                  "adabelief"])
def test_optax_rule_optimizers_on_the_card(cuda, name):
    """Three clipped steps with weight decay and an LR change on the card
    end within 1e-5 relative of the same steps on the CPU."""
    from audio_only_speech_separation_tpu_torch.train import make_optimizer, set_learning_rate

    rng = np.random.default_rng(5)
    shapes = [(4, 3), (7,), (160, 128), (3, 128, 144)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(sc * rng.standard_normal(s) / 100).astype(np.float32) for s in shapes] for sc in (4.0, 0.3, 9.0)]
    out = []
    for dev in ("cpu", cuda):
        params = [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev)) for p in p0]
        opt = make_optimizer(params, optim_name=name, lr=1e-2, weight_decay=0.01, grad_clip=5.0)
        for i, g in enumerate(grads):
            if i == 2:
                set_learning_rate(opt, 3e-3)
            for p, gi in zip(params, g):
                p.grad = torch.from_numpy(gi.copy()).to(dev)
            opt.step()
        out.append([p.detach().cpu() for p in params])
    for a, b in zip(out[1], out[0]):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm())


@pytest.mark.parametrize("generalized", [True, False])
def test_mixit_on_the_card(cuda, generalized):
    """MixIT's loss, gradient and estimate mixtures on the card within 1e-5
    relative of the CPU's."""
    from audio_only_speech_separation_tpu_torch.losses import MixITLossWrapper, multisrc_neg_snr

    rng = np.random.default_rng(6)
    est = rng.standard_normal((3, 4, 4000)).astype(np.float32)
    mixes = rng.standard_normal((3, 2, 4000)).astype(np.float32)
    out = []
    for dev in ("cpu", cuda):
        e = torch.from_numpy(est).to(dev).requires_grad_()
        loss, est_mix = MixITLossWrapper(multisrc_neg_snr, generalized=generalized)(
            e, torch.from_numpy(mixes).to(dev), return_est=True)
        loss.backward()
        out.append((loss.detach().cpu(), e.grad.cpu(), est_mix.detach().cpu()))
    for a, b in zip(out[1], out[0]):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm())


def test_remat_through_k2_and_k3_on_the_card(cuda, tmp_path):
    """A bf16 ConvTasNet step through the TCN chain's kernels with and
    without remat: bit-identical loss and gradients, K2 and K3 launched
    once either way (remat recomputes nothing on the fused path)."""
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer

    model = _model(cuda).train()
    rng = np.random.default_rng(7)
    mix = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32)).to(cuda)
    srcs = torch.from_numpy(rng.standard_normal((2, 2, 8000)).astype(np.float32)).to(cuda)
    loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx")
    got = {}
    for remat in (False, True):
        trainer = Trainer(str(tmp_path / f"e{remat}"), precision="bfloat16", fused_forward=True, remat=remat,
                          logger=CSVLogger(str(tmp_path / "logs")))
        forward = trainer.train_module(model)
        model.zero_grad(set_to_none=True)
        k2, k3 = fused_tcn_separator.launches, fused_tcn_backward.launches
        loss = loss_fn(forward(mix, 0), srcs)
        loss.backward()
        torch.cuda.synchronize()
        got[remat] = (loss.detach(), [p.grad.clone() for p in model.parameters()],
                      fused_tcn_separator.launches - k2, fused_tcn_backward.launches - k3)
    nb = model.R * model.X
    assert torch.equal(got[False][0], got[True][0])
    assert all(torch.equal(a, b) for a, b in zip(got[False][1], got[True][1]))
    assert got[False][2:] == got[True][2:] == (tcn_separator_launches(nb), tcn_backward_launches(nb))


# K5 and K6 inside a (bi)LSTM layer trained on bf16 casts of its f32
# parameters (the Trainer's cast policy), at the training shapes: BSRNN's
# band RNN (K6: 501 frames, B 32 = 4 utterances x 8 bands, in 128, H 256) and
# band-comm RNN (K6: 8 bands, B 2004, H 256) at B=4 x 4 s x 8 kHz; DPRNN's
# rows (K6: 100 frames, B 164) and columns (K6: 82 chunks, B 200) at B=2 x
# 4 s x 8 kHz (in 64, H 128); and BSRNN's band RNN at B=1 (K5: B 8), where
# ops/rnn.py::kernel_choice takes K5
CAST_POLICY_CASES = [(501, 32, 128, 256, "K6"), (8, 2004, 128, 256, "K6"), (100, 164, 64, 128, "K6"),
                     (82, 200, 64, 128, "K6"), (501, 8, 128, 256, "K5")]


@pytest.mark.parametrize("T,B,Din,H,kernel", CAST_POLICY_CASES)
def test_lstm_kernel_gradients_under_the_cast_policy(cuda, T, B, Din, H, kernel):
    """A BiLSTM with its output projection on bf16 casts of f32 parameters
    and input: the kernel form (one launch of ``kernel``, none in the
    backward) against the same form inside ``plain_versions()``.  The
    backward of both runs autograd through the plain version on the same
    saved inputs, and the cotangent reaching the LSTM does not depend on
    its output, so for one cotangent the gradients of the input and of the
    LSTM's f32 parameters agree to f32 rounding (rel-l2 < 1e-4); the
    projection's weight gradient, a product with the LSTM's output, and
    the outputs agree to bf16 rounding (rel-l2 < 2e-2, max abs < 2e-2)."""
    from audio_only_speech_separation_tpu_torch.ops.kernels import plain_versions
    from audio_only_speech_separation_tpu_torch.ops.rnn import ProjRNN

    layer = ProjRNN(Din, H, bidirectional=True).to(cuda)
    rng = np.random.default_rng(T + B)
    x32 = torch.from_numpy(rng.standard_normal((B, T, Din)).astype(np.float32)).to(cuda)
    g = _bf16(cuda, rng.standard_normal((B, T, Din)))
    counter = fused_bilstm if kernel == "K5" else resident_bilstm

    def run(plain):
        params = dict(layer.named_parameters())
        for p in params.values():
            p.grad = None
        x = x32.clone().requires_grad_()
        cast = {k: p.to(torch.bfloat16) for k, p in params.items()}
        with plain_versions() if plain else contextlib.nullcontext():
            before = counter.launches
            out = torch.func.functional_call(layer, cast, (x.to(torch.bfloat16),))
            forward = counter.launches - before
            out.backward(g)
            torch.cuda.synchronize()
            backward = counter.launches - before - forward
        return out.detach(), forward, backward, {"x": x.grad, **{k: p.grad for k, p in params.items()}}

    out_k, fwd_k, bwd_k, grads_k = run(False)
    out_p, fwd_p, _, grads_p = run(True)
    assert (fwd_k, bwd_k, fwd_p) == (1, 0, 0)
    assert float((out_k.float() - out_p.float()).abs().max()) < 2e-2
    for name, a in grads_p.items():
        limit = 2e-2 if name == "proj.weight" else 1e-4
        assert a.dtype == torch.float32 and _rel(a, grads_k[name]) < limit, (name, _rel(a, grads_k[name]))


# ---------------------------------------------------------------------------
# Sandglasset (K4 in its 3-D and 4-D forms, K6), DPRNNTasNet (K5, K6), the
# rest of the TasNet modules
# ---------------------------------------------------------------------------


def test_sandglasset_kernel_path_meets_the_validator_rule(cuda):
    """A Sandglasset (bn 64, 4 heads of dh 16, H 64, chunks of 50, 4 blocks)
    at B=2 x 1 s x 8 kHz (8001 frames: 323 chunks an utterance) cast to
    bf16: each block attends once through K4 (blocks 0 and 3 in the 4-D
    form) and runs its intra BiLSTM (646 sequences) through K6, within the
    1.5x rule of the f32 module."""
    from audio_only_speech_separation_tpu_torch.models import Sandglasset

    m = Sandglasset(n_feats=32, bn_chan=64, hid_size=64, chunk_size=50, hop_size=25, n_repeats=4, n_head=4,
                    sample_rate=8000, generator=torch.Generator().manual_seed(17)).to(cuda).eval()
    launched = _validator_rule(m, _waves(cuda, 18, 2, 8000), (k4_launches, fused_bilstm, resident_bilstm))
    assert launched == [4, 0, 4]


def test_batched_axis1_attention_kernel_form_matches_plain_form(cuda):
    """The 4-D attention's kernel form (the projections written straight
    into K4's layout and back) against its plain form in bf16 at
    Sandglasset's widths ([2, 131, 250, 128], 8 heads): within 2e-2 of each
    other's output."""
    from audio_only_speech_separation_tpu_torch.ops.attention import (
        MultiheadAttention,
        mha_batched_axis1_kernel_form,
        mha_batched_axis1_plain_form,
    )

    m = MultiheadAttention(128, 8).to(cuda, torch.bfloat16).eval()
    x = _bf16(cuda, np.random.default_rng(19).standard_normal((2, 131, 250, 128)))
    w = (m.in_proj_weight, m.in_proj_bias, m.out_proj.weight, m.out_proj.bias)
    before = fused_attention_bdt.launches
    with torch.no_grad():
        got = mha_batched_axis1_kernel_form(x, *w, 8)
        want = mha_batched_axis1_plain_form(x, *w, 8)
    torch.cuda.synchronize()
    assert fused_attention_bdt.launches - before == 1
    assert float((got.float() - want.float()).abs().max()) < 2e-2


@pytest.mark.parametrize("batch,launched", [(1, [0, 0, 4]), (8, [0, 0, 4])])
def test_dprnn_tasnet_kernel_path_meets_the_validator_rule(cuda, batch, launched):
    """A DPRNNTasNet (feature 64, H 128, 2 layers, segments of 32) at B x
    1 s x 8 kHz (1006 frames: 64 chunks an utterance) cast to bf16: rows
    and columns through K6 at batch 1 (64 and 32 sequences of width 64)
    and at batch 8 (512 and 256), within the 1.5x rule of the f32 module."""
    from audio_only_speech_separation_tpu_torch.models import DPRNNTasNet

    m = DPRNNTasNet(feature_dim=64, hidden_dim=128, sample_rate=8000, layer=2,
                    generator=torch.Generator().manual_seed(20)).to(cuda).eval()
    counters = (k4_launches, fused_bilstm, resident_bilstm)
    assert _validator_rule(m, _waves(cuda, 21, batch, 8000), counters) == launched


TASNET_MODULE_CASES = [("TCN", 1, [0, 0, 0]), ("SudoRMRF", 1, [0, 0, 0]), ("GC_TCN", 2, [0, 0, 4]),
                       ("GC_SudoRMRF", 2, [0, 0, 4]), ("DPRNN", 2, [0, 0, 8]), ("DPTNet", 2, [4, 0, 8])]


@pytest.mark.parametrize("module,group_size,launched", TASNET_MODULE_CASES)
def test_tasnet_modules_meet_the_validator_rule(cuda, module, group_size, launched):
    """A TasNet (enc and bn 64, H 128, 2 layers, chunks of 50, context 24) of
    each separator module at B=4 x 1 s x 8 kHz cast to bf16: TCN and
    SudoRM-RF run no kernel; with group size 2 the context GC_RNNs (4
    layers, 4 x 86 windows x 2 groups) take K6, and so do the grouped
    cores' rows (4 x 2 x 6 sequences) and columns (4 x 2 x 50), whose input
    is 32 wide, DPTNet's attention K4 (dh 8); within the 1.5x rule of the
    f32 module."""
    from audio_only_speech_separation_tpu_torch.models import TasNet

    m = TasNet(enc_dim=64, bn_dim=64, hidden_dim=128, layer=2, module=module, group_size=group_size,
               block_size=50, sample_rate=8000, generator=torch.Generator().manual_seed(22)).to(cuda).eval()
    counters = (k4_launches, fused_bilstm, resident_bilstm)
    assert _validator_rule(m, _waves(cuda, 23, 4, 8000), counters) == launched


# ---------------------------------------------------------------------------
# Data-parallel training and chunked separation on the card
# ---------------------------------------------------------------------------


def test_two_gloo_ranks_on_one_card_match_one_process(cuda, tmp_path):
    """Two ranks on the one card over gloo, half the batch each, against one
    process with all of it, on a ConvTasNet inside K2's envelope: in f32 the
    loss within 1e-5 and the gradients (DDP's mean) and updated parameters
    within rtol 2e-4 / atol 2e-5 (JAX's tolerance for a sharded step); in
    bf16 through K2 + K3 the loss within 1e-3 relative, and the two arms'
    gradients and updated parameters no further apart than the plain bf16
    path's (the chain's plain versions) from f32's, as phase 40 of
    chip_smoke.py holds them (each rank's weight gradients are rounded to
    bf16 before the mean)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_ddp import card_steps, launch

    (ranks, _), _ = launch("card", str(tmp_path), one_card=True, timeout=300)
    one = card_steps(str(tmp_path))
    (l2, p2, g2), (l1, p1, g1) = ranks["float32"], one["float32"]
    assert abs(l2 - l1) <= 1e-5 * max(1.0, abs(l1))
    for k, v in g1.items():
        np.testing.assert_allclose(g2[k], v, rtol=2e-4, atol=2e-5, err_msg=f"float32 gradient {k}")
    for k, v in p1.items():
        np.testing.assert_allclose(p2[k], v, rtol=2e-4, atol=2e-5, err_msg=f"float32 {k}")

    def flat(tree):
        return np.concatenate([tree[k].ravel() for k in sorted(g1)])

    two_bf16, one_bf16, plain, f32 = ranks["bfloat16"], one["bfloat16"], one["plain bf16"], one["float32"]
    assert abs(two_bf16[0] - one_bf16[0]) <= 1e-3 * max(1.0, abs(one_bf16[0]))
    for what, i in (("gradients", 2), ("parameters after one Adam step", 1)):
        gap = np.linalg.norm(flat(two_bf16[i]) - flat(one_bf16[i]))
        margin = np.linalg.norm(flat(plain[i]) - flat(f32[i]))
        print(f"bf16 {what}: |2 ranks - 1 process| {gap:.6g}, |plain bf16 - f32| {margin:.6g}")
        assert 0 < margin and gap <= margin, (what, gap, margin)


def test_world_one_nccl_step_is_the_unwrapped_step(cuda, tmp_path, monkeypatch):
    """Under a process group of one rank over NCCL, ``Trainer``'s train
    module is DistributedDataParallel, and a bf16 step through K2 + K3 gives
    the unwrapped module's loss and gradients bit for bit."""
    import socket

    import torch.distributed as dist

    from audio_only_speech_separation_tpu_torch import parallel
    from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
    from audio_only_speech_separation_tpu_torch.train import CSVLogger, Trainer
    from audio_only_speech_separation_tpu_torch.train.trainer import TrainForward

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    model = _model(cuda).train()
    rng = np.random.default_rng(11)
    mix = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32)).to(cuda)
    srcs = torch.from_numpy(rng.standard_normal((2, 2, 8000)).astype(np.float32)).to(cuda)
    loss_fn = PITLossWrapper(pairwise_neg_snr)
    assert parallel.init_distributed() == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        trainer = Trainer(str(tmp_path), precision="bfloat16", fused_forward=True,
                          logger=CSVLogger(str(tmp_path / "logs")))
        modules = [trainer.train_module(model), TrainForward(model, trainer._make_forward(model), 42, 0, False)]
        assert type(modules[0]).__name__ == "DistributedDataParallel"
        got = []
        for module in modules:
            model.zero_grad(set_to_none=True)
            before = fused_tcn_separator.launches, fused_tcn_backward.launches
            loss = loss_fn(module(mix, 0), srcs)
            loss.backward()
            torch.cuda.synchronize()
            got.append((loss.detach(), [p.grad.clone() for p in model.parameters()],
                        fused_tcn_separator.launches - before[0], fused_tcn_backward.launches - before[1]))
    finally:
        dist.destroy_process_group()
    nb = model.R * model.X
    assert torch.equal(got[0][0], got[1][0])
    assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))
    assert got[0][2:] == got[1][2:] == (tcn_separator_launches(nb), tcn_backward_launches(nb))


def test_chunked_separation_through_k1(cuda, monkeypatch):
    """``chunked_separate`` with bf16 on the card separates the windows in
    one K1 call and stays within the 1.5x rule of the f32 module against the
    plain bf16 path (K1's plain version); a recording no longer than a
    window is one call too."""
    import functools

    from audio_only_speech_separation_tpu_torch import serve as serve_module
    from audio_only_speech_separation_tpu_torch.utils.chunked_inference import chunked_separate

    m = _model(cuda)
    kw = dict(window_seconds=1.0, overlap_seconds=0.25, sample_rate=8000, device=cuda)
    for T in (20000, 7000):
        wav = (0.3 * np.random.default_rng(T).standard_normal(T)).astype(np.float32)
        before = fused_convtasnet_separator.launches
        got = chunked_separate(m, wav, use_bf16=True, **kw)
        assert fused_convtasnet_separator.launches - before == convtasnet_separator_launches(m.R * m.X)
        ref = chunked_separate(m, wav, use_bf16=False, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(serve_module, "fused_inference_forward", functools.partial(
                serve_module.fused_inference_forward, separator=convtasnet_separator_reference))
            plain = chunked_separate(m, wav, use_bf16=True, **kw)
        assert got.shape == ref.shape == (2, T) and np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1.5 * np.abs(plain - ref).max() + 1e-3


def test_bench_checks_k1_then_times_it(cuda):
    """The port's bench at a small shape: K1 checked against its plain
    version (one call), a warm-up and the timed calls, each one K1 call;
    the root bench's line with the card's name."""
    from audio_only_speech_separation_tpu_torch import bench

    before = fused_convtasnet_separator.launches
    result = bench.run(batch=1, seconds=0.5, iters=3)
    assert fused_convtasnet_separator.launches - before == (1 + 1 + 3) * convtasnet_separator_launches(24)
    assert result["value"] > 0 and result["device"] == torch.cuda.get_device_name(0)
    assert result["vs_baseline"] == pytest.approx(result["value"] / bench.A100_EST, abs=1e-3)


def _train_arms(cuda, model, forms):
    """{arm: (f32 estimate, f32 gradients)} of one loss on ``model`` for the
    f32 module, the plain bf16 module (the Trainer's cast policy) and each
    of ``forms`` ({name: forward})."""
    from audio_only_speech_separation_tpu_torch.train import bf16_forward

    rng = np.random.default_rng(3)
    mix = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy(rng.standard_normal((2, model.num_spks, 8000)).astype(np.float32)).to(cuda)
    arms = {"f32": model, "plain bf16": bf16_forward(model), **forms}
    out = {}
    for name, forward in arms.items():
        est = forward(mix)
        grads = torch.autograd.grad(((est.float() - tgt) ** 2).mean(), list(model.parameters()))
        out[name] = (est.detach().float(), torch.cat([g.flatten().float() for g in grads]))
    return out


def _meets_the_rule(arms, name):
    (e_f, g_f), (e_p, g_p), (e, g) = arms["f32"], arms["plain bf16"], arms[name]
    err, plain = float((e - e_f).abs().max()), float((e_p - e_f).abs().max())
    assert err <= 1.5 * plain + 1e-3, (name, err, plain)
    gerr, gplain = float((g - g_f).norm()), float((g_p - g_f).norm())
    assert torch.isfinite(g).all() and gerr <= 1.5 * gplain + 1e-3 * float(g_f.norm()), (name, gerr, gplain)


def test_convtasnet_train_forms_on_the_card(cuda):
    """The fused train form launches K1 once a forward (its backward none:
    it recomputes through the plain bf16 module); it, the delayed form and
    the channels-last module (bf16 casts) meet the 1.5x rule against the
    f32 module, outputs and gradients, with the plain bf16 module as the
    margin."""
    from audio_only_speech_separation_tpu_torch.models.convtasnet import (
        make_delayed_train_apply,
        make_fused_train_apply,
    )
    from audio_only_speech_separation_tpu_torch.train import bf16_forward

    m = _model(cuda).train()
    cl = ConvTasNet(N=256, H=256, B=128, L=16, X=3, R=1, num_spks=2, sample_rate=8000,
                    channels_last=True).to(cuda).train()
    cl.load_state_dict(m.state_dict())
    before = fused_convtasnet_separator.launches
    arms = _train_arms(cuda, m, {"fused": bf16_forward(m, apply_fn=make_fused_train_apply(m)),
                                 "delayed": bf16_forward(m, apply_fn=make_delayed_train_apply(m))})
    assert fused_convtasnet_separator.launches - before == convtasnet_separator_launches(m.R * m.X)
    for name in ("fused", "delayed"):
        _meets_the_rule(arms, name)
    arms["channels last"] = _train_arms(cuda, cl, {"channels last": bf16_forward(cl)})["channels last"]
    _meets_the_rule(arms, "channels last")


def test_sequence_parallel_step_on_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """A (1, 2) mesh of two gloo ranks on the one card, TasNet-DPRNN and
    BSRNN in f32: each rank's partial gradients sum to the one process's on
    the card, and after the reduction every rank holds its gradients, loss
    and updated parameters (rtol 2e-4, atol 2e-5, JAX's tolerance for a
    sharded step)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_ddp import SP_TRAIN, family_model, launch, sp_batch, train_step

    ranks = [res for res, _ in launch("sp_train", str(tmp_path), one_card=True, timeout=300, args=("2", "cuda"))]
    mix, sources = sp_batch()
    tol = dict(rtol=2e-4, atol=2e-5)
    for family in SP_TRAIN:
        loss, params, grads = train_step(family, family_model(family, 12), mix, sources, str(tmp_path),
                                         device=cuda)
        for k, v in grads.items():
            np.testing.assert_allclose(sum(r[f"{family} partial"][k] for r in ranks), v, err_msg=k, **tol)
        for r in ranks:
            assert abs(r[family][0] - loss) <= 1e-5 * max(1.0, abs(loss))
            for k, v in grads.items():
                np.testing.assert_allclose(r[family][2][k], v, err_msg=k, **tol)
            for k, v in params.items():
                np.testing.assert_allclose(r[family][1][k], v, err_msg=k, **tol)


# ---------------------------------------------------------------------------
# the layer library's blocks through K4, K5 and K6; the STFTs on the card
# ---------------------------------------------------------------------------

# (block, its input shape, its K4, K5, K6 launches a call in bf16 on the card;
# ops/rnn.py::kernel_choice takes K5 for 64 or more steps of width 128 or more
# over 16 or fewer sequences, K6 elsewhere)
LAYER_CASES = {
    "DPRNN rows K6, columns K5": (lambda: _layers().DPRNN(128, 64, n_repeats=2), (1, 128, 4, 64), [0, 2, 2]),
    "DPRNN at B=1": (lambda: _layers().DPRNN(32, 64, n_repeats=2), (1, 32, 50, 40), [0, 0, 4]),
    "DPRNNBlock one-direction columns, K6": (lambda: _layers().DPRNNBlock(32, 64, bidirectional=False),
                                             (4, 32, 50, 40), [0, 0, 2]),
    "DPRNNBlock one-direction columns, K5": (lambda: _layers().DPRNNBlock(128, 64, bidirectional=False),
                                             (1, 128, 4, 64), [0, 1, 1]),
    "SingleRNN one direction, K5": (lambda: _layers().SingleRNN(128, 128), (8, 101, 128), [0, 1, 0]),
    "SingleRNN one direction, K6": (lambda: _layers().SingleRNN(64, 128), (200, 21, 64), [0, 0, 1]),
    "LSTMBlockTF": (lambda: _layers().LSTMBlockTF(64, 128), (8, 101, 64), [0, 0, 1]),
    "DPRNNLinear": (lambda: _layers().DPRNNLinear(32, 64, 40), (4, 32, 50, 40), [0, 0, 1]),
    "TransformerBlockTF": (lambda: _layers().TransformerBlockTF(128, 4, 256), (16, 100, 128), [1, 0, 0]),
}


def _layers():
    from audio_only_speech_separation_tpu_torch import layers

    return layers


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_layer_blocks_take_the_kernels_under_the_validator_rule(cuda, case):
    """Each block of ``layers/`` that reaches a kernel, in bf16 on the card
    at a reduced width: the launches stated, within the 1.5x rule of the f32
    block (``_validator_rule``); the one-direction LSTM runs on K5 and K6
    (D = 1)."""
    ctor, shape, launched = LAYER_CASES[case]
    torch.manual_seed(len(case))
    m = ctor().to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(shape).astype(np.float32)).to(cuda)
    assert _validator_rule(m, x, (k4_launches, fused_bilstm, resident_bilstm)) == launched


def test_stfts_on_the_card_match_the_cpu(cuda):
    """``stft_matmul``, ``forward_stft``/``inverse_stft`` (each mode) and the
    ``STFT``/``iSTFT`` layers on the card against the CPU, f32, within 1e-5
    of the output's largest magnitude (an uncentred inverse where the
    overlapped squared window covers the signal)."""
    from audio_only_speech_separation_tpu_torch.layers import stft_lib
    from audio_only_speech_separation_tpu_torch.ops.stft import hann_window, stft_matmul

    x = torch.from_numpy(np.random.default_rng(24).standard_normal((2, 8000)).astype(np.float32))

    def close(got, want):
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())

    for a, b in zip(stft_matmul(x.to(cuda), 256, 64, hann_window(256, device=cuda)),
                    stft_matmul(x, 256, 64, hann_window(256))):
        close(a, b)
    for mode, kw in (("librosa", {}), ("kaldi", dict(pre_emphasis=0.97)), ("torch", dict(center=True))):
        spec = stft_lib.forward_stft(x, 400, 160, mode=mode, **kw)
        close(stft_lib.forward_stft(x.to(cuda), 400, 160, mode=mode, **kw), spec)
        kw.pop("pre_emphasis", None)
        edge = 0 if kw.get("center") else 512  # uncentred: where the squared window covers the signal
        got = stft_lib.inverse_stft(spec.to(cuda), 400, 160, mode=mode, **kw)
        want = stft_lib.inverse_stft(spec, 400, 160, mode=mode, **kw)
        close(got[:, edge:got.shape[1] - edge], want[:, edge:want.shape[1] - edge])
    fwd, inv = stft_lib.STFT(512, 128, center=True), stft_lib.iSTFT(512, 128, center=True)
    close(inv(fwd(x.to(cuda))), inv(fwd(x)))
