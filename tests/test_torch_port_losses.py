"""The port's losses against the JAX package's, on the CPU: the three NegSDR
families with their aliases, and PITLossWrapper in its three modes.

Same float32 inputs (numpy, seeded) through both; values, and gradients
with respect to the estimates (as a whole, l2), agree within 1e-5
relative: float32 sums taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_only_speech_separation_tpu.losses as jl
import audio_only_speech_separation_tpu_torch.losses as tl

torch.set_num_threads(2)
RTOL = 1e-5


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal(shape).astype(np.float32)
    est = (tgt + 0.5 * rng.standard_normal(shape)).astype(np.float32)
    return est, tgt


def _value_and_grad_both(jfn, tfn, est, tgt):
    jv, jg = jax.value_and_grad(lambda e: jnp.sum(jfn(e, jnp.asarray(tgt))))(jnp.asarray(est))
    te = torch.from_numpy(est).requires_grad_()
    tv = tfn(te, torch.from_numpy(tgt)).sum()
    tv.backward()
    return (float(jv), np.asarray(jg)), (float(tv.detach()), te.grad.numpy())


def _close(got, want):
    (gv, gg), (wv, wg) = got, want
    assert abs(gv - wv) <= RTOL * max(abs(wv), 1e-3), (gv, wv)
    assert np.linalg.norm(gg - wg) <= RTOL * np.linalg.norm(wg)


@pytest.mark.parametrize("family,shape", [("PairwiseNegSDR", (3, 3, 400)),
                                          ("SingleSrcNegSDR", (4, 400)),
                                          ("MultiSrcNegSDR", (3, 2, 400))])
@pytest.mark.parametrize("sdr_type", ["snr", "sisdr", "sdsdr"])
@pytest.mark.parametrize("zero_mean,take_log", [(True, True), (False, False)])
def test_negsdr_families_match_jax(family, shape, sdr_type, zero_mean, take_log):
    est, tgt = _inputs(0, shape)
    jfn = getattr(jl, family)(sdr_type, zero_mean=zero_mean, take_log=take_log)
    tfn = getattr(tl, family)(sdr_type, zero_mean=zero_mean, take_log=take_log)
    want, got = _value_and_grad_both(jfn, tfn, est, tgt)
    _close(got, want)


@pytest.mark.parametrize("alias", ["pairwise_neg_sisdr", "pairwise_neg_sdsdr", "pairwise_neg_snr",
                                   "singlesrc_neg_sisdr", "singlesrc_neg_sdsdr", "singlesrc_neg_snr",
                                   "multisrc_neg_sisdr", "multisrc_neg_sdsdr", "multisrc_neg_snr"])
def test_aliases_and_registry_match_jax(alias):
    shape = (3, 400) if alias.startswith("singlesrc") else (2, 3, 400)
    est, tgt = _inputs(1, shape)
    want, got = _value_and_grad_both(jl.get(alias), tl.get(alias), est, tgt)
    _close(got, want)


def test_masked_pairwise_matches_jax():
    est, tgt = _inputs(2, (2, 3, 300))
    mask = np.ones((2, 300), np.float32)
    mask[1, 200:] = 0.0
    want = np.asarray(jl.pairwise_neg_sisdr(jnp.asarray(est), jnp.asarray(tgt), mask=jnp.asarray(mask)))
    got = tl.pairwise_neg_sisdr(torch.from_numpy(est), torch.from_numpy(tgt), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("pit_from,threshold", [("pw_mtx", True), ("pw_mtx", False),
                                                ("pw_pt", True), ("perm_avg", False)])
def test_pit_matches_jax(pit_from, threshold):
    """Loss, its gradient, and the reordered estimates.  The batch mixes
    items above and below -30 dB, so the threshold changes the mean."""
    rng = np.random.default_rng(3)
    tgt = rng.standard_normal((4, 3, 500)).astype(np.float32)
    perm = [2, 0, 1]
    noise = np.array([0.5, 0.02, 0.3, 0.015], np.float32)[:, None, None]  # 34 and 36 dB
    est = (tgt[:, perm] + noise * rng.standard_normal((4, 3, 500))).astype(np.float32)
    loss = {"pw_mtx": "pairwise_neg_snr", "pw_pt": "singlesrc_neg_sisdr",
            "perm_avg": "multisrc_neg_sisdr"}[pit_from]
    jw = jl.PITLossWrapper(jl.get(loss), pit_from=pit_from, threshold_byloss=threshold)
    tw = tl.PITLossWrapper(tl.get(loss), pit_from=pit_from, threshold_byloss=threshold)
    want, got = _value_and_grad_both(jw, tw, est, tgt)
    _close(got, want)
    _, j_re = jw(jnp.asarray(est), jnp.asarray(tgt), return_ests=True)
    _, t_re = tw(torch.from_numpy(est), torch.from_numpy(tgt), return_ests=True)
    np.testing.assert_array_equal(t_re.numpy(), np.asarray(j_re))
    # the near-clean items come back in target order
    np.testing.assert_allclose(t_re.numpy()[[1, 3]], tgt[[1, 3]], atol=0.1)


def test_pit_threshold_changes_the_mean():
    """Items at or below -30 dB drop out of the mean (pit_wrapper.py:59-61)."""
    rng = np.random.default_rng(4)
    tgt = torch.from_numpy(rng.standard_normal((2, 2, 400)).astype(np.float32))
    est = tgt.clone()
    est[0] += 0.5 * torch.from_numpy(rng.standard_normal((2, 400)).astype(np.float32))
    on = tl.PITLossWrapper(tl.pairwise_neg_snr, threshold_byloss=True)(est, tgt)
    off = tl.PITLossWrapper(tl.pairwise_neg_snr, threshold_byloss=False)(est, tgt)
    single = tl.PITLossWrapper(tl.pairwise_neg_snr, threshold_byloss=False)(est[:1], tgt[:1])
    assert float(on) == pytest.approx(float(single), rel=1e-6) and float(off) < float(on)


def test_registry_rejects_unknown_names():
    with pytest.raises(ValueError):
        tl.get("no_such_loss")
    with pytest.raises(ValueError):
        tl.PITLossWrapper(tl.pairwise_neg_snr, pit_from="hungarian")
