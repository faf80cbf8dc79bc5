"""Separation of recordings longer than a training window (counterpart of
``audio_only_speech_separation_tpu/utils/chunked_inference.py``).

Separation models train on short segments, and recordings run for
minutes.  ``chunked_separate`` cuts a long waveform into overlapping
windows, separates the whole window batch in one forward through the
serving dispatch (``serve.choose_dispatch``: a bf16 ConvTasNet inside the
kernel's envelope on the card runs K1), then stitches:

1. each window's speaker order is aligned to the previous window's by
   the correlation of their estimates over the overlap (a PIT-trained
   model may order the speakers differently in two forwards);
2. the windows are blended by a linear crossfade over the overlap.

Under a process group each rank separates its share of the windows, and
rank 0 gathers and stitches them (the JAX package shards the window batch
over its ``dp`` mesh).
"""

from __future__ import annotations

from itertools import permutations
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..serve import Server


def _best_perm_by_overlap(prev_tail: np.ndarray, cur_head: np.ndarray) -> tuple:
    """The speaker order of ``cur_head`` that maximises the summed
    normalised correlation with ``prev_tail`` (both [n_src, T_overlap])."""
    n = prev_tail.shape[0]
    best, best_p = -np.inf, tuple(range(n))
    for p in permutations(range(n)):
        score = 0.0
        for i, j in enumerate(p):
            a, b = prev_tail[i], cur_head[j]
            denom = np.linalg.norm(a) * np.linalg.norm(b) + 1e-8
            score += float(np.dot(a, b)) / denom
        if score > best:
            best, best_p = score, p
    return best_p


def _separate_windows(server: Server, batch: np.ndarray) -> np.ndarray:
    """[W, win] windows -> [W, n_src, win] estimates, float32: the whole
    batch on one process, else this rank's contiguous share, gathered on
    rank 0 (the other ranks get None)."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    share = -(-len(batch) // world)
    mine = batch[rank * share : (rank + 1) * share]
    est = np.zeros((0,), np.float32)
    if len(mine):
        est = server.forward(torch.from_numpy(mine).to(server.device)).float().cpu().numpy()
    if world == 1:
        return est
    shares = [None] * world if rank == 0 else None
    dist.gather_object(est, shares, dst=0)
    if rank != 0:
        return None
    return np.concatenate([s for s in shares if s.size], 0)


def chunked_separate(model, wav: np.ndarray, window_seconds: float = 8.0, overlap_seconds: float = 1.0,
                     sample_rate: Optional[int] = None, device="cuda", use_bf16: bool = True):
    """Separate a mono waveform of any length ([T]) -> [n_src, T] float32
    (None on ranks other than 0 under a process group).  A waveform no
    longer than a window is separated in one forward.  Raises when
    ``device`` is CUDA and there is no card."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("chunked_separate: no CUDA device; pass device=\"cpu\" to separate on the CPU")
    server = Server(model, use_bf16, device)
    sr = sample_rate or getattr(model, "sample_rate", 16000)
    win = int(window_seconds * sr)
    hop = win - int(overlap_seconds * sr)
    ov = win - hop
    T = wav.shape[-1]
    if T <= win:
        est = _separate_windows(server, np.asarray(wav, np.float32)[None])
        return None if est is None else est[0]

    n_win = -(-(T - ov) // hop)
    padded = np.zeros(ov + (n_win - 1) * hop + win, np.float32)
    padded[:T] = wav
    starts = [k * hop for k in range(n_win)]
    est = _separate_windows(server, np.stack([padded[s : s + win] for s in starts], 0))
    if est is None:
        return None

    out = np.zeros((est.shape[1], padded.shape[0]), np.float32)
    weight = np.zeros(padded.shape[0], np.float32)
    ramp = np.linspace(0.0, 1.0, ov, dtype=np.float32)

    def window_weight(k):
        """Complementary linear crossfades: the overlaps sum to 1."""
        w = np.ones(win, np.float32)
        if k > 0:
            w[:ov] = ramp
        if k < n_win - 1:
            w[-ov:] = ramp[::-1]
        return w

    cur = est[0]
    out[:, :win] += cur * window_weight(0)
    weight[:win] += window_weight(0)
    for k in range(1, n_win):
        s = starts[k]
        cur = est[k][list(_best_perm_by_overlap(cur[:, -ov:], est[k][:, :ov]))]
        w = window_weight(k)
        out[:, s : s + win] += cur * w
        weight[s : s + win] += w
    out /= np.maximum(weight, 1e-8)
    return out[:, :T]
