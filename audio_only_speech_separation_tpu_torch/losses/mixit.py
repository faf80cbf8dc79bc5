"""Mixture-invariant training (MixIT; counterpart of
``audio_only_speech_separation_tpu/losses/mixit.py``; reference
look2hear/losses/mixit.py:109-318).

The loss of the source-to-mixture partition that fits best:
``generalized=True`` takes every 2-way partition of the estimates with both
sides non-empty (two mixtures), ``generalized=False`` every partition into
the mixtures in parts of equal size.  Each partition is a fixed 0/1
assignment matrix [n_mix, n_src], so summing the estimates under it is a
matrix product, and the best partition's estimate mixtures come from a
gather of those matrices: no loop over the batch.
"""

from __future__ import annotations

from itertools import combinations
from typing import Callable, List, Sequence

import numpy as np
import torch


def _parts_equal(n_src: int, n_mix: int) -> List[List[Sequence[int]]]:
    """All partitions of range(n_src) into n_mix parts of equal size, in the
    JAX package's order."""
    k = n_src // n_mix

    def rec(lst, parts_left):
        if parts_left == 0:
            yield []
            return
        for c in combinations(lst, k):
            rest = [x for x in lst if x not in c]
            for r in rec(rest, parts_left - 1):
                yield [list(c), *r]

    return list(rec(list(range(n_src)), n_mix))


def _parts_generalized(n_src: int) -> List[List[Sequence[int]]]:
    """All 2-way partitions of range(n_src) with both sides non-empty, in
    the JAX package's order."""
    out = []
    lst = list(range(n_src))
    for k in range(n_src + 1):
        for c in combinations(lst, k):
            if c and len(c) != n_src:
                out.append([list(c), [x for x in lst if x not in c]])
    return out


def _assignment_tensor(parts, n_mix: int, n_src: int) -> np.ndarray:
    """[n_parts, n_mix, n_src] 0/1 matrices: A[p] @ sources sums partition p."""
    A = np.zeros((len(parts), n_mix, n_src), dtype=np.float32)
    for p, partition in enumerate(parts):
        for m, idxs in enumerate(partition):
            A[p, m, list(idxs)] = 1.0
    return A


class MixITLossWrapper:
    def __init__(self, loss_func: Callable, generalized: bool = True):
        self.loss_func = loss_func
        self.generalized = generalized

    def __call__(self, est_targets, targets, return_est: bool = False, **kwargs):
        """est_targets [B, n_src, T], targets (the mixtures) [B, n_mix, T] ->
        the mean over the batch of the best partition's loss, and with
        ``return_est`` also the estimate mixtures of that partition [B,
        n_mix, T]."""
        if est_targets.shape[0] != targets.shape[0] or est_targets.shape[2] != targets.shape[2]:
            raise ValueError(f"estimates {tuple(est_targets.shape)} and mixtures {tuple(targets.shape)} "
                             "differ in batch or length")
        n_mix, n_src = targets.shape[1], est_targets.shape[1]
        if self.generalized:
            if n_mix != 2:
                raise ValueError("generalized MixIT works only with two mixtures")
            parts = _parts_generalized(n_src)
        else:
            if n_src % n_mix != 0:
                raise ValueError("mixtures are assumed to contain the same number of sources")
            parts = _parts_equal(n_src, n_mix)
        A = torch.from_numpy(_assignment_tensor(parts, n_mix, n_src)).to(est_targets.device, est_targets.dtype)
        loss_set = torch.stack([
            self.loss_func(torch.einsum("ms,bst->bmt", A[p], est_targets), targets, **kwargs)
            for p in range(len(parts))], dim=1)  # [B, P]
        min_loss, best = loss_set.min(dim=1)
        mean_loss = min_loss.mean()
        if not return_est:
            return mean_loss
        return mean_loss, torch.einsum("bms,bst->bmt", A[best], est_targets)
