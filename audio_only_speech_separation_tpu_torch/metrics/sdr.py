"""BSS-eval SDR with an optimal distortion filter (fast_bss_eval parity); a
copy of ``audio_only_speech_separation_tpu/metrics/sdr.py``, numpy and
scipy only, kept here because the port imports nothing of the JAX package.

The reference scores SDR via ``fast_bss_eval.sdr_pit_loss``
(metrics/wrapper.py:39-41): for each (reference, estimate) pair, fit the
length-512 FIR filter h minimizing ‖est − h∗ref‖² (a Toeplitz normal-
equation solve) and report 10·log10(‖h∗ref‖² / ‖est − h∗ref‖²), with PIT
over source permutations.

This is an offline eval metric, so it runs host-side: FFT correlations +
``scipy.linalg.solve_toeplitz`` — no device round-trips in the hot loop.
"""

from __future__ import annotations

from itertools import permutations

import numpy as np

try:
    from scipy.linalg import solve_toeplitz

    _HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    _HAVE_SCIPY = False


def _corr(x: np.ndarray, y: np.ndarray, n_lags: int) -> np.ndarray:
    """Cross-correlation r[k] = sum_t x[t] y[t+k] for k in [0, n_lags)."""
    n = len(x) + n_lags
    n_fft = 1 << (n - 1).bit_length()
    X = np.fft.rfft(x, n_fft)
    Y = np.fft.rfft(y, n_fft)
    r = np.fft.irfft(np.conj(X) * Y, n_fft)
    return r[:n_lags]


def _pair_sdr(ref: np.ndarray, est: np.ndarray, filter_length: int) -> float:
    """SDR of one (ref, est) pair with the optimal FIR distortion filter."""
    ref = ref - ref.mean()
    est = est - est.mean()
    acf = _corr(ref, ref, filter_length)
    xcf = _corr(ref, est, filter_length)
    acf = acf.copy()
    acf[0] += 1e-8 * max(acf[0], 1e-20)  # regularize the Toeplitz solve
    if _HAVE_SCIPY:
        h = solve_toeplitz(acf, xcf)
    else:
        # explicit Toeplitz build as a fallback
        T = np.array(
            [[acf[abs(i - j)] for j in range(filter_length)] for i in range(filter_length)]
        )
        h = np.linalg.solve(T, xcf)
    # energy of the projection: h^T r (normal equations identity)
    coh = float(np.dot(h, xcf))
    est_energy = float(np.dot(est, est))
    num = coh
    den = est_energy - coh
    eps = 1e-12
    return 10.0 * np.log10(max(num, eps) / max(den, eps))


def sdr_matrix(refs: np.ndarray, ests: np.ndarray, filter_length: int = 512) -> np.ndarray:
    """[n_ref, n_est] SDR matrix."""
    n_ref, n_est = refs.shape[0], ests.shape[0]
    out = np.zeros((n_ref, n_est))
    fl = min(filter_length, refs.shape[-1])
    for i in range(n_ref):
        for j in range(n_est):
            out[i, j] = _pair_sdr(refs[i], ests[j], fl)
    return out


def sdr_pit(refs: np.ndarray, ests: np.ndarray, filter_length: int = 512) -> np.ndarray:
    """Per-source SDR under the permutation maximizing mean SDR.

    Matches the reference's `-fast_bss_eval.sdr_pit_loss(ref, est)` usage
    (metrics/wrapper.py:39-41).
    """
    mat = sdr_matrix(refs, ests, filter_length)
    n = mat.shape[0]
    best, best_perm = -np.inf, None
    for perm in permutations(range(n)):
        s = mat[np.arange(n), list(perm)].mean()
        if s > best:
            best, best_perm = s, perm
    return mat[np.arange(n), list(best_perm)]
