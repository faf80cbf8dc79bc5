"""The plain versions of the dual-path kernels (attention K4, the LSTM
recurrences K5 and K6) against the JAX package's references on the CPU:
forward in float32 (1e-5) and bfloat16 (the validator's bounds), the
gradients against the JAX VJPs, and the wrappers' refusal of a device they
have no kernel for.  The JAX kernels run through their plain references
here (``_einsum_attention_bdt``, ``_xla_bilstm``, ``_xla_resident_ref``),
as the JAX package's own CPU tests run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.ops.pallas.attention import _einsum_attention_bdt
from audio_only_speech_separation_tpu.ops.pallas.lstm import _xla_bilstm, _xla_resident_ref
from audio_only_speech_separation_tpu_torch.ops.kernels import attention as k4
from audio_only_speech_separation_tpu_torch.ops.kernels.attention import (
    attention_bdt_reference,
    attention_packed_reference,
    fused_attention_bdt,
    fused_attention_packed,
)
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import (
    bilstm_reference,
    fused_bilstm,
    resident_bilstm,
    resident_bilstm_reference,
)

torch.set_num_threads(2)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def bf16_np(a):
    """numpy f32 -> JAX bf16 (the same rounding as torch's)."""
    return jnp.asarray(a).astype(jnp.bfloat16)


def max_err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max())


# [BH, dh, T], T not a multiple of 16 included; the kernel's edges: T on
# either side of a 16-query tile (15, 16, 17), DPTNet's columns (42) and
# the batch-1 12 s rows (242, past a 128-query block and a 128-key chunk),
# dh 8 and 256
ATTN = [(4, 16, 100), (3, 8, 37), (2, 32, 1), (5, 24, 129), (3, 16, 15), (3, 16, 16), (3, 16, 17),
        (4, 16, 42), (2, 16, 242), (2, 8, 50), (1, 256, 40)]


@pytest.mark.parametrize("BH,dh,T", ATTN)
def test_attention_plain_version_matches_jax(BH, dh, T):
    rng = np.random.default_rng(BH * T)
    q, k, v = (rng.standard_normal((BH, dh, T)).astype(np.float32) for _ in range(3))
    want = np.asarray(_einsum_attention_bdt(q, k, v))
    got = attention_bdt_reference(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the wrapper runs the plain version on a CPU tensor
    assert np.array_equal(fused_attention_bdt(t(q), t(k), t(v)).numpy(), got)
    want_b = _einsum_attention_bdt(bf16_np(q), bf16_np(k), bf16_np(v)).astype(jnp.float32)
    bf = torch.bfloat16
    got_b = attention_bdt_reference(t(q, bf), t(k, bf), t(v, bf)).float().numpy()
    assert max_err(got_b, want_b) < 2e-2



def _tokens(a, B, h):
    """[B*h, dh, T] -> [B, T, E], head j in columns j*dh : (j+1)*dh."""
    _, dh, T = a.shape
    return a.reshape(B, h, dh, T).permute(0, 3, 1, 2).reshape(B, T, h * dh)


def _packed(q, k, v, B, h):
    """[B*h, dh, T] q, k, v -> the packed in-projection [B, T, 3E]."""
    return torch.cat([_tokens(a, B, h) for a in (q, k, v)], -1)


def _unpacked(o, h):
    """[B, T, E] -> [B*h, dh, T]."""
    B, T, E = o.shape
    return o.reshape(B, T, h, E // h).permute(0, 2, 3, 1).reshape(B * h, E // h, T)


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
@pytest.mark.parametrize("T", [1, 13, 34, 250])
def test_packed_plain_version_is_the_bdt_one_permuted(T, dh):
    """The packed entry's plain version on [B, T, 3E] is bit for bit
    ``attention_bdt_reference`` on the same q, k and v in [B*h, dh, T], in
    float32 and bfloat16; on a CPU tensor the wrapper runs it."""
    B, h = 2, 3
    rng = np.random.default_rng(T * dh)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t(rng.standard_normal((B * h, dh, T)), dtype) for _ in range(3))
        qkv = _packed(q, k, v, B, h)
        got = attention_packed_reference(qkv, h)
        assert got.shape == (B, T, h * dh) and got.dtype == dtype
        assert torch.equal(_unpacked(got, h), attention_bdt_reference(q, k, v))
        assert torch.equal(fused_attention_packed(qkv, h), got)


def test_packed_attention_gradients_match_jax_vjp(monkeypatch):
    """Autograd of the packed entry on the CPU (its plain version) against
    the VJP of the JAX kernel entry on the same q, k and v in [B*h, dh, T];
    and the entry's own backward (recomputing through the plain version,
    the launch replaced by it) equal to autograd of the plain version."""
    B, h, dh, T = 2, 2, 16, 21
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((B * h, dh, T)).astype(np.float32) for _ in range(4))
    qkv = _packed(t(q), t(k), t(v), B, h).requires_grad_()
    (got,) = torch.autograd.grad(fused_attention_packed(qkv, h), qkv, _tokens(t(g), B, h))
    _, vjp = jax.vjp(_einsum_attention_bdt, q, k, v)
    want = _packed(*(t(np.array(a)) for a in vjp(g)), B, h)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)

    monkeypatch.setattr(k4, "_launch_packed", attention_packed_reference)
    go = torch.from_numpy(rng.standard_normal((B, T, h * dh)).astype(np.float32))
    (through_entry,) = torch.autograd.grad(k4._AttentionPacked.apply(qkv, h), qkv, go)
    (plain,) = torch.autograd.grad(attention_packed_reference(qkv, h), qkv, go)
    assert torch.equal(through_entry, plain)


@pytest.mark.parametrize("qkv,heads,match", [
    (torch.zeros(2, 5, 3 * 2 * 4), 2, "dh % 8 == 0"),  # dh 4
    (torch.zeros(2, 5, 3 * 264), 1, "dh % 8 == 0"),  # dh 264
    (torch.zeros(2, 5, 50), 2, "3 \\* 2 \\* dh"),  # 50 is no 3 * 2 * dh
    (torch.zeros(2, 0, 3 * 2 * 16), 2, "T >= 1"),
    (torch.zeros(2, 3 * 2 * 16, 5).transpose(1, 2), 2, "contiguous"),
], ids=["dh4", "dh264", "not3E", "T0", "strided"])
def test_packed_wrapper_refuses_what_the_kernel_does_not_take(qkv, heads, match):
    """The packed entry raises on a head width outside the envelope, on a
    last axis that is not 3 * heads * dh, on T = 0 and on a non-contiguous
    ``qkv``, on any device."""
    with pytest.raises(ValueError, match=match):
        fused_attention_packed(qkv, heads)

# (T, D, B, H): one and two directions, an odd batch; the kernel's edges:
# T = 1, a partial 16-row tile (B 17), the batch-1 column pass's 100
# sequences at H 128 with a short T, and H 48 and 256 (other cluster and
# pairs-per-warp plans)
BILSTM = [(13, 2, 5, 16), (9, 1, 3, 32), (20, 2, 1, 16), (1, 2, 4, 32), (6, 2, 17, 16),
          (5, 2, 100, 128), (7, 2, 3, 48), (4, 1, 2, 256)]


@pytest.mark.parametrize("T,D,B,H", BILSTM)
def test_bilstm_plain_version_matches_jax(T, D, B, H):
    rng = np.random.default_rng(T * B)
    xw = (rng.standard_normal((T, D, B, 4 * H)) * 0.3).astype(np.float32)
    whh = (rng.standard_normal((D, H, 4 * H)) * 0.05).astype(np.float32)
    want = np.asarray(_xla_bilstm(xw, whh))
    got = bilstm_reference(t(xw), t(whh)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(fused_bilstm(t(xw), t(whh)).numpy(), got)
    want_b = _xla_bilstm(bf16_np(xw), bf16_np(whh)).astype(jnp.float32)
    got_b = bilstm_reference(t(xw, torch.bfloat16), t(whh, torch.bfloat16)).float().numpy()
    assert max_err(got_b, want_b) < 1e-2


# (T, B, Din, H, D, bias)
RESIDENT = [(11, 7, 16, 16, 2, True), (6, 3, 8, 32, 1, True), (9, 5, 16, 16, 2, False),
            (4, 1, 16, 16, 1, False)]


@pytest.mark.parametrize("T,B,Din,H,D,with_bias", RESIDENT)
def test_resident_bilstm_plain_version_matches_jax(T, B, Din, H, D, with_bias):
    rng = np.random.default_rng(T * B + D)
    x = (rng.standard_normal((B, T, Din)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((D, Din, 4 * H)) * 0.08).astype(np.float32)
    whh = (rng.standard_normal((D, H, 4 * H)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((D, 4 * H)) * 0.05).astype(np.float32) if with_bias else None
    tb = None if bias is None else t(bias)
    want = np.asarray(_xla_resident_ref(x, wih, whh, bias))
    got = resident_bilstm_reference(t(x), t(wih), t(whh), tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.array_equal(resident_bilstm(t(x), t(wih), t(whh), tb).numpy(), got)
    bf = torch.bfloat16
    want_b = _xla_resident_ref(bf16_np(x), bf16_np(wih), bf16_np(whh),
                               None if bias is None else bf16_np(bias)).astype(jnp.float32)
    got_b = resident_bilstm_reference(t(x, bf), t(wih, bf), t(whh, bf), tb).float().numpy()
    assert max_err(got_b, want_b) < 1e-2


def _grads(fn, inputs, g):
    leaves = [t(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    return [a.numpy() for a in torch.autograd.grad(out, leaves, t(g))]


def test_attention_gradients_match_jax_vjp():
    """Autograd of the plain version, which is the wrapper's backward,
    against the VJP of the JAX kernel entry (its einsum form)."""
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.standard_normal((3, 16, 21)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(_einsum_attention_bdt, q, k, v)
    for got, want in zip(_grads(fused_attention_bdt, (q, k, v), g), vjp(g)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_bilstm_gradients_match_jax_vjp():
    rng = np.random.default_rng(1)
    xw = (rng.standard_normal((8, 2, 3, 64)) * 0.3).astype(np.float32)
    whh = (rng.standard_normal((2, 16, 64)) * 0.05).astype(np.float32)
    g = rng.standard_normal((8, 2, 3, 16)).astype(np.float32)
    _, vjp = jax.vjp(_xla_bilstm, xw, whh)
    for got, want in zip(_grads(fused_bilstm, (xw, whh), g), vjp(g)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_resident_bilstm_gradients_match_jax_vjp():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5, 7, 16)) * 0.5).astype(np.float32)
    wih = (rng.standard_normal((2, 16, 64)) * 0.08).astype(np.float32)
    whh = (rng.standard_normal((2, 16, 64)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal((2, 64)) * 0.05).astype(np.float32)
    g = rng.standard_normal((7, 2, 5, 16)).astype(np.float32)
    _, vjp = jax.vjp(_xla_resident_ref, x, wih, whh, bias)
    got = _grads(resident_bilstm, (x, wih, whh, bias), g)
    for a, want in zip(got, vjp(g)):
        np.testing.assert_allclose(a, np.asarray(want), rtol=1e-4, atol=1e-5)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: fused_attention_bdt(_meta(2, 16, 10), _meta(2, 16, 10), _meta(2, 16, 10)),
    lambda: fused_attention_packed(_meta(2, 10, 3 * 2 * 16), 2),
    lambda: fused_bilstm(_meta(5, 2, 3, 64), _meta(2, 16, 64)),
    lambda: resident_bilstm(_meta(3, 5, 16), _meta(2, 16, 64), _meta(2, 16, 64),
                            _meta(2, 64, dtype=torch.float32)),
], ids=["attention", "attention_packed", "bilstm", "resident"])
def test_wrapper_refuses_a_device_without_kernel(call):
    """No silent fallback: a tensor on neither the CPU nor a CUDA device
    raises instead of running the plain version."""
    with pytest.raises(ValueError, match="no .* kernel for device meta"):
        call()
