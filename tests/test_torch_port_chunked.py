"""Chunked separation of long recordings (``utils/chunked_inference.py``)
against the JAX package's, on a tiny ConvTasNet with shared weights: the
stitched output within 1e-4 of the output's scale, the speaker alignment
(swaps detected, 2 and 3 speakers), the short-input passthrough, and the
card default."""

import numpy as np
import pytest
import torch

from audio_only_speech_separation_tpu.utils.chunked_inference import _best_perm_by_overlap as jax_best_perm
from audio_only_speech_separation_tpu.utils.chunked_inference import chunked_separate as jax_chunked
from audio_only_speech_separation_tpu_torch.utils.chunked_inference import _best_perm_by_overlap, chunked_separate
from torch_port_helpers import assert_close, make_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=21)


@pytest.mark.parametrize("n_src", [2, 3])
def test_speaker_alignment_matches_jax(n_src):
    """The overlap correlation picks the JAX package's order: the identity
    on a noisy copy, the inverse of a permutation on a permuted one."""
    rng = np.random.default_rng(n_src)
    a = rng.standard_normal((n_src, 400)).astype(np.float32)
    for perm in ([1, 0] if n_src == 2 else [2, 0, 1], list(range(n_src))):
        cur = a[perm] + 0.01 * rng.standard_normal((n_src, 400)).astype(np.float32)
        got = _best_perm_by_overlap(a, cur)
        assert got == jax_best_perm(a, cur)
        assert np.array_equal(cur[list(got)], cur[np.argsort(perm)])


@pytest.mark.parametrize("T,use_bf16", [(20000, False), (20000, True), (7000, False)])
def test_chunked_separation_matches_jax(pair, T, use_bf16):
    """1 s windows with a 0.25 s overlap at 8 kHz: a 2.5 s recording takes
    three windows, stitched with the speaker alignment and the crossfade;
    0.875 s is one window, passed through whole.  On the CPU the window
    batch runs the f32 module (the dispatch's "eager"), with or without
    bf16, as the JAX package's does."""
    jm, params, tm = pair
    wav = (0.3 * np.random.default_rng(T).standard_normal(T)).astype(np.float32)
    want = jax_chunked(jm, params, wav, window_seconds=1.0, overlap_seconds=0.25, sample_rate=8000)
    got = chunked_separate(tm, wav, window_seconds=1.0, overlap_seconds=0.25, sample_rate=8000, device="cpu",
                           use_bf16=use_bf16)
    assert got.shape == want.shape == (2, T) and got.dtype == np.float32
    assert_close(got, want, rel=1e-4)


def test_windows_are_realigned_when_a_window_swaps_its_speakers(pair, monkeypatch):
    """A model whose estimates swap speakers in every other window gives
    the stitched output of the one that never swaps: the alignment undoes
    each swap before the crossfade."""
    from audio_only_speech_separation_tpu_torch.serve import Server

    _, _, tm = pair
    wav = (0.3 * np.random.default_rng(3).standard_normal(20000)).astype(np.float32)
    kw = dict(window_seconds=1.0, overlap_seconds=0.25, sample_rate=8000, device="cpu", use_bf16=False)
    straight = chunked_separate(tm, wav, **kw)
    real = Server.forward

    def swapping(self, mix):
        est = real(self, mix)
        est[1::2] = est[1::2].flip(1)
        return est

    monkeypatch.setattr(Server, "forward", swapping)
    np.testing.assert_array_equal(chunked_separate(tm, wav, **kw), straight)


def test_chunked_separation_defaults_to_the_card(pair, monkeypatch):
    """Without a card the call raises unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunked_separate(pair[2], np.zeros(9000, np.float32))
