"""CPU checks around the redesigned chain-backward (K3) and resident-LSTM
(K6) kernels, against the JAX package:

- ``from_pretrain`` loads onto the card by default and raises without
  one, unless the caller asks for the CPU;
- K3's plain version against ``jax.vjp`` of the JAX chain oracle at the
  edges the kernel's tiling must handle: a dilation larger than a 64-frame
  tile, T' not a multiple of 64, a batch of one;
- K6's plain version against the JAX package's ``_xla_resident_ref`` at
  B = 1, T = 1, D = 1 and Din 128 / H 256;
- the gate-column interleave and fragment order in which the K6 wrapper
  packs W_ih and W_hh: round-tripped, and one plain LSTM step run on the
  interleaved columns;
- K5's few-sequence body: the rule that picks it (``small_batch_body``),
  and the gate-row order in which its wrapper packs W_hh^T
  (``pack_gate_rows``) against each element's place in the mma's A
  fragment and against its inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import make_pair

from audio_only_speech_separation_tpu.models import save_serialized as jax_save
from audio_only_speech_separation_tpu.models import serialize as jax_serialize
from audio_only_speech_separation_tpu.ops.pallas.convtasnet_backward import tcn_chain_xla
from audio_only_speech_separation_tpu.ops.pallas.lstm import _xla_resident_ref
from audio_only_speech_separation_tpu_torch.models import from_pretrain
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_backward import fused_tcn_backward
from audio_only_speech_separation_tpu_torch.ops.kernels.convtasnet_block import fused_tcn_separator
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
    _step,
    gate_interleave,
    pack_gate_fragments,
    pack_gate_rows,
    resident_bilstm,
    resident_bilstm_reference,
    small_batch_body,
    unpack_gate_fragments,
    unpack_gate_rows,
)

torch.set_num_threads(2)

NAMES = ("dx", "dw1s", "dwsgs", "dvecs", "dcs", "dalphas")


@pytest.fixture
def jax_checkpoint(tmp_path):
    jm, params, _ = make_pair(seed=31)
    path = str(tmp_path / "best_model.pth")
    jax_save(jax_serialize(jm, params), path)
    return path, jm


def test_from_pretrain_defaults_to_the_card_and_raises_without_one(jax_checkpoint, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_pretrain(jax_checkpoint[0])


def test_from_pretrain_loads_on_the_cpu_when_asked(jax_checkpoint):
    path, jm = jax_checkpoint
    model = from_pretrain(path, device="cpu")
    assert model.num_spks == jm.num_spks
    assert all(p.device.type == "cpu" for p in model.parameters())


def _rel(want, got):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.linalg.norm(want - got) / (np.linalg.norm(want) + 1e-9))


# (nb, H, B, T'): dilations 2**b up to 128 (larger than a 64-frame tile),
# T' not a multiple of 64, a batch of one
K3_EDGES = [(8, 128, 2, 200), (2, 128, 2, 133), (3, 128, 1, 150)]


@pytest.mark.parametrize("nb,H,B,T", K3_EDGES)
def test_chain_backward_plain_version_matches_jax_vjp_at_the_edges(nb, H, B, T):
    """fused_tcn_backward on CPU tensors (K3's plain version, on the saved
    state of K2's plain version) against jax.vjp(tcn_chain_xla): rel-l2 <
    6e-2 for each cotangent, the kernel's own bound on the card."""
    rng = np.random.default_rng(nb * T + B)
    x = rng.normal(size=(B, T, 128)).astype(np.float32)
    w1s = (rng.normal(size=(nb, 128, H)) * 0.1).astype(np.float32)
    wsgs = (rng.normal(size=(nb, H, 128)) * 0.1).astype(np.float32)
    vecs = (rng.normal(size=(nb, 8, H)) * 0.3).astype(np.float32)
    vecs[:, 7] = 0.0
    cs = (rng.normal(size=(nb, 2, 128)) * 0.1).astype(np.float32)
    alphas = (np.abs(rng.normal(size=(nb, 2))) * 0.3 + 0.05).astype(np.float32)
    g = rng.normal(size=(B, T, 128)).astype(np.float32)
    dils = tuple(2**b for b in range(nb))
    bf = jnp.bfloat16
    ja = (jnp.asarray(x, bf), jnp.asarray(w1s, bf), jnp.asarray(wsgs, bf), jnp.asarray(vecs),
          jnp.asarray(cs), jnp.asarray(alphas))
    _, vjp = jax.vjp(lambda *a: tcn_chain_xla(*a, dils), *ja)
    want = vjp(jnp.asarray(g, bf))

    tb = torch.bfloat16
    ta = (torch.from_numpy(x).to(tb), torch.from_numpy(w1s).to(tb), torch.from_numpy(wsgs).to(tb),
          torch.from_numpy(vecs), torch.from_numpy(cs), torch.from_numpy(alphas))
    y, y_hist, stats = fused_tcn_separator(*ta, dils, save_state=True)
    got = fused_tcn_backward(torch.from_numpy(g).to(tb), y_hist, y, stats, *ta[1:], dils)
    for name, w, t in zip(NAMES, want, got):
        assert t.shape == tuple(w.shape), name
        assert _rel(w, t.float().numpy()) < 6e-2, (name, _rel(w, t.float().numpy()))
    assert bool((got[3][:, 7] == 0).all())


# (T, B, Din, H, D, bias): a batch of one, one step, one direction, and the
# widest envelope (Din 128, H 256)
K6_EDGES = [(9, 1, 16, 32, 2, True), (1, 4, 16, 16, 2, True), (7, 3, 32, 16, 1, False),
            (3, 2, 128, 256, 2, True)]


@pytest.mark.parametrize("T,B,Din,H,D,with_bias", K6_EDGES)
def test_resident_plain_version_matches_jax_at_the_edges(T, B, Din, H, D, with_bias):
    """resident_bilstm on CPU tensors (K6's plain version) against
    _xla_resident_ref: f32 to 1e-5, bf16 within the validator's 1e-2."""
    rng = np.random.default_rng(T * B + Din + H)
    x = (rng.standard_normal((B, T, Din)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((D, Din, 4 * H)) * 0.08).astype(np.float32)
    whh = (rng.standard_normal((D, H, 4 * H)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((D, 4 * H)) * 0.05).astype(np.float32) if with_bias else None
    tb = None if bias is None else torch.from_numpy(bias)
    want = np.asarray(_xla_resident_ref(x, wih, whh, bias))
    got = resident_bilstm(torch.from_numpy(x), torch.from_numpy(wih), torch.from_numpy(whh), tb)
    assert got.shape == (T, D, B, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    bf, jbf = torch.bfloat16, jnp.bfloat16
    want_b = _xla_resident_ref(jnp.asarray(x, jbf), jnp.asarray(wih, jbf), jnp.asarray(whh, jbf),
                               None if bias is None else jnp.asarray(bias, jbf))
    got_b = resident_bilstm_reference(torch.from_numpy(x).to(bf), torch.from_numpy(wih).to(bf),
                                      torch.from_numpy(whh).to(bf), tb)
    assert float(np.abs(got_b.float().numpy() - np.asarray(want_b, np.float32)).max()) < 1e-2


@pytest.mark.parametrize("D,K,H", [(2, 64, 128), (1, 16, 16), (2, 128, 256), (1, 32, 48)])
def test_gate_fragment_packing_round_trips(D, K, H):
    """pack_gate_fragments is a permutation of the weight: unpacking gives it
    back exactly, and each packed element sits where the mma.sync B
    fragment of its lane expects it (k = 16 ks + 2 (l % 4) + e % 2 + 8 (e //
    2), n = 8 nt + l // 4 of the interleaved columns)."""
    w = torch.from_numpy(np.random.default_rng(K + H).standard_normal((D, K, 4 * H)).astype(np.float32))
    packed = pack_gate_fragments(w.to(torch.bfloat16))
    assert packed.shape == (D, 4 * H // 8, K // 16, 32, 4) and packed.is_contiguous()
    assert torch.equal(unpack_gate_fragments(packed), w.to(torch.bfloat16))
    perm = gate_interleave(H)
    assert torch.equal(torch.sort(perm).values, torch.arange(4 * H))
    wp = w[:, :, perm]
    d, nt, ks, lane, e = np.meshgrid(*(np.arange(n) for n in packed.shape), indexing="ij")
    k = 16 * ks + 2 * (lane % 4) + e % 2 + 8 * (e // 2)
    n = 8 * nt + lane // 4
    assert torch.equal(packed.float(), wp[d, k, n].to(torch.bfloat16).float())


def test_plain_step_on_interleaved_gate_columns():
    """One LSTM step whose gate pre-activations are computed on the
    interleaved columns (as the kernel's accumulators hold them) and put
    back in torch order by the inverse permutation equals the plain step:
    each thread's columns 8 nt + 2q and 2q + 1 of n-tiles 2p and 2p + 1 are
    i, f, g, o of hidden unit 4p + q."""
    rng = np.random.default_rng(3)
    D, B, Din, H = 2, 5, 32, 32
    x = torch.from_numpy(rng.standard_normal((D, B, Din)).astype(np.float32))
    h = torch.from_numpy(np.tanh(rng.standard_normal((D, B, H))).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((D, B, H)).astype(np.float32) * 0.5)
    wih = torch.from_numpy(rng.standard_normal((D, Din, 4 * H)).astype(np.float32) * 0.1)
    whh = torch.from_numpy(rng.standard_normal((D, H, 4 * H)).astype(np.float32) * 0.1)
    perm = gate_interleave(H)
    gates_p = torch.matmul(x, wih[:, :, perm]) + torch.matmul(h, whh[:, :, perm])  # interleaved
    nt = torch.arange(4 * H) // 8
    col = torch.arange(4 * H) % 8
    unit, gate = 4 * (nt // 2) + col // 2, 2 * (nt % 2) + col % 2
    assert torch.equal(gate * H + unit, perm)
    gates = gates_p[..., torch.argsort(perm)]
    h1, c1 = _step(torch.matmul(x, wih), h, c, whh)
    i, f, g, o = gates.split(H, dim=-1)
    c32 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    torch.testing.assert_close(c32, c1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.sigmoid(o) * torch.tanh(c32), h1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B", [1, 8, 16, 17])
@pytest.mark.parametrize("H", [16, 256])
@pytest.mark.parametrize("D", [1, 2])
def test_small_batch_body_rule(B, D, H):
    """K5 takes its few-sequence body at 16 sequences or fewer, for either
    direction count, at both ends of the hidden widths it takes."""
    assert small_batch_body(B, D, H) == (B <= 16)


def test_small_batch_body_stays_inside_the_envelope():
    """No few-sequence body outside the kernels' envelope: H not a multiple
    of 16 or above 256, three directions, no sequence."""
    assert not small_batch_body(8, 2, 24) and not small_batch_body(8, 2, 272)
    assert not small_batch_body(8, 3, 256) and not small_batch_body(0, 2, 256)


def _a_fragment_placement(w: np.ndarray) -> np.ndarray:
    """W_hh^T's elements where the few-sequence body's warps read them, one
    by one from mma.m16n8k16's A-fragment layout: warp j's tile mt, k-step
    ks, lane l = 4 g + q, register r, half h hold A[row][col] with row
    g + 8 (r % 2), col 2 q + h + 8 (r // 2); A's row of tile 0 is gate i
    (rows < 8) or f of unit 8 j + g, of tile 1 gate g or o; col is k within
    the k-step."""
    D, H, G = w.shape
    out = np.zeros((D, H // 8, 2, H // 16, 32, 8), w.dtype)
    for d in range(D):
        for j in range(H // 8):
            for mt in range(2):
                for ks in range(H // 16):
                    for lane in range(32):
                        g, q = lane // 4, lane % 4
                        for r in range(4):
                            for h in range(2):
                                row, col = g + 8 * (r % 2), 2 * q + h + 8 * (r // 2)
                                gate = 2 * mt + row // 8
                                out[d, j, mt, ks, lane, 2 * r + h] = w[d, 16 * ks + col, gate * H + 8 * j + g]
    return out


@pytest.mark.parametrize("D,H", [(2, 16), (1, 48), (2, 128), (1, 256)])
def test_gate_row_packing_matches_the_fragment_layout(D, H):
    """pack_gate_rows puts each element of W_hh where the few-sequence
    body's A fragments expect it, and unpack_gate_rows undoes it exactly."""
    w = np.random.default_rng(D + H).standard_normal((D, H, 4 * H)).astype(np.float32)
    packed = pack_gate_rows(torch.from_numpy(w).to(torch.bfloat16))
    assert packed.shape == (D, H // 8, 2, H // 16, 32, 8) and packed.is_contiguous()
    want = torch.from_numpy(_a_fragment_placement(w)).to(torch.bfloat16)
    assert torch.equal(packed, want)
    assert torch.equal(unpack_gate_rows(packed), torch.from_numpy(w).to(torch.bfloat16))
    assert torch.equal(unpack_gate_rows(want), torch.from_numpy(w).to(torch.bfloat16))
