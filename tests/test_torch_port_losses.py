"""The port's losses against the JAX package's, on the CPU: the three NegSDR
families with their aliases, PITLossWrapper in its three modes with the host
Hungarian solver for many sources, and MixITLossWrapper.

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
from audio_only_speech_separation_tpu.losses import pit as jpit
from audio_only_speech_separation_tpu_torch.losses import pit as tpit

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


@pytest.mark.parametrize("generalized,n_src,n_mix", [(True, 4, 2), (True, 3, 2), (False, 4, 2), (False, 6, 3)])
def test_mixit_matches_jax(generalized, n_src, n_mix):
    """MixIT's loss, its gradient and (``return_est``) the best partition's
    estimate mixtures against the JAX package's, in both modes, through the
    registry; the estimates are a noisy known partition of the mixtures'
    sources, so the best partition is clear."""
    rng = np.random.default_rng(10 + n_src)
    srcs = rng.standard_normal((3, n_src, 400)).astype(np.float32)
    parts = np.array_split(rng.permutation(n_src), n_mix) if not generalized else [[0], list(range(1, n_src))]
    mixes = np.stack([srcs[:, p].sum(1) for p in parts], 1)
    est = (srcs + 0.3 * rng.standard_normal(srcs.shape)).astype(np.float32)
    jw = jl.get("MixITLossWrapper")(jl.multisrc_neg_snr, generalized=generalized)
    tw = tl.get("MixITLossWrapper")(tl.multisrc_neg_snr, generalized=generalized)
    want, got = _value_and_grad_both(jw, tw, est, mixes)
    _close(got, want)
    jl_, j_est = jw(jnp.asarray(est), jnp.asarray(mixes), return_est=True)
    tl_, t_est = tw(torch.from_numpy(est), torch.from_numpy(mixes), return_est=True)
    assert t_est.shape == (3, n_mix, 400)
    np.testing.assert_allclose(t_est.numpy(), np.asarray(j_est), rtol=RTOL, atol=RTOL)
    assert abs(float(tl_) - float(jl_)) <= RTOL * abs(float(jl_))


def test_mixit_refuses_what_the_jax_package_refuses():
    est, mixes = torch.zeros(1, 4, 10), torch.zeros(1, 3, 10)
    with pytest.raises(ValueError, match="two mixtures"):
        tl.MixITLossWrapper(tl.multisrc_neg_snr)(est, mixes)
    with pytest.raises(ValueError, match="same number of sources"):
        tl.MixITLossWrapper(tl.multisrc_neg_snr, generalized=False)(est, mixes)


@pytest.mark.parametrize("n_src", [3, 7])
def test_hungarian_best_perm_matches_jax(n_src):
    """The host Hungarian solve against the JAX package's on the same
    pairwise losses: the same assignment and mean loss; at 3 sources also
    the device enumeration's answer.  Past 6 sources ``find_best_perm``
    names it."""
    rng = np.random.default_rng(20 + n_src)
    pwl = rng.standard_normal((4, n_src, n_src)).astype(np.float32)
    want_loss, want_idx = jpit.hungarian_best_perm(pwl)
    got_loss, got_idx = tpit.hungarian_best_perm(torch.from_numpy(pwl))
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    if n_src <= 6:
        dev_loss, dev_idx = tpit.find_best_perm(torch.from_numpy(pwl))
        np.testing.assert_array_equal(dev_idx.numpy(), got_idx)
        np.testing.assert_allclose(dev_loss.numpy(), got_loss, rtol=1e-5)
    else:
        with pytest.raises(NotImplementedError, match="hungarian_best_perm"):
            tpit.find_best_perm(torch.from_numpy(pwl))
