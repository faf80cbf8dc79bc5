"""Permutation-invariant training (counterpart of
``audio_only_speech_separation_tpu/losses/pit.py``; reference
look2hear/losses/pit_wrapper.py:15-142).

Modes ``pw_mtx`` / ``pw_pt`` / ``perm_avg``, the -30 dB loss threshold, and
source reordering by the best permutation.  The best permutation is found
on the device by enumerating all n! permutations (up to n_src = 6) in one
contraction with a fixed one-hot tensor: no host round-trip.  Past 6
sources ``hungarian_best_perm`` solves it on the host (scipy's Hungarian
solver), outside the training step.
"""

from __future__ import annotations

from itertools import permutations as _permutations
from typing import Callable, Optional

import numpy as np
import torch

_MAX_FACTORIAL_N = 6


def _perm_tensors(n_src: int, device=None):
    """[n!, n] permutation indices and the [n!, n, n] one-hot tensor."""
    perms = np.array(list(_permutations(range(n_src))), dtype=np.int64)
    one_hot = np.zeros((len(perms), n_src, n_src), dtype=np.float32)
    one_hot[np.arange(len(perms))[:, None], np.arange(n_src)[None, :], perms] = 1.0
    return torch.from_numpy(perms).to(device), torch.from_numpy(one_hot).to(device)


def find_best_perm(pair_wise_losses: torch.Tensor):
    """pair_wise_losses [B, n_est, n_tgt] -> (min_loss [B], batch_indices
    [B, n]); ``batch_indices[b, i]`` is the estimate matched to target i."""
    n_src = pair_wise_losses.shape[-1]
    if n_src > _MAX_FACTORIAL_N:
        raise NotImplementedError(
            f"on-device PIT enumerates up to n_src={_MAX_FACTORIAL_N}; "
            f"got {n_src}. Use hungarian_best_perm (host) for larger n."
        )
    pwl = pair_wise_losses.transpose(-1, -2)  # [B, tgt, est]
    perms, one_hot = _perm_tensors(n_src, pwl.device)
    loss_set = torch.einsum("bij,pij->bp", pwl, one_hot.to(pwl.dtype)) / n_src
    min_loss, idx = loss_set.min(dim=1)
    return min_loss, perms[idx]


def hungarian_best_perm(pair_wise_losses):
    """``find_best_perm`` on the host for any n_src (scipy's Hungarian
    solver; eval time only): pair_wise_losses [B, n_est, n_tgt] (a tensor
    or an array) -> numpy (min_loss [B], batch_indices [B, n])."""
    from scipy.optimize import linear_sum_assignment

    if isinstance(pair_wise_losses, torch.Tensor):
        pair_wise_losses = pair_wise_losses.detach().cpu().numpy()
    pwl = np.swapaxes(np.asarray(pair_wise_losses), -1, -2)
    batch_indices = np.stack([linear_sum_assignment(m)[1] for m in pwl])
    min_loss = np.take_along_axis(pwl, batch_indices[..., None], axis=2).mean((-1, -2))
    return min_loss, batch_indices


def reorder_sources(sources: torch.Tensor, batch_indices: torch.Tensor):
    """sources [B, n, T], batch_indices [B, n] -> sources[b, batch_indices[b]]."""
    return torch.gather(sources, 1, batch_indices[:, :, None].expand(-1, -1, sources.shape[-1]))


class PITLossWrapper:
    """Permutation-invariant loss (reference pit_wrapper.py:15-67).

    ``threshold_byloss``: per-item losses <= -30 dB drop out of the mean
    unless that empties the batch (pit_wrapper.py:59-61)."""

    def __init__(self, loss_func: Callable, pit_from: str = "pw_mtx",
                 perm_reduce: Optional[Callable] = None, threshold_byloss: bool = True):
        if pit_from not in ("pw_mtx", "pw_pt", "perm_avg"):
            raise ValueError(
                f"Unsupported loss function type {pit_from}. Expected one of "
                "[`pw_mtx`, `pw_pt`, `perm_avg`]"
            )
        self.loss_func = loss_func
        self.pit_from = pit_from
        self.perm_reduce = perm_reduce
        self.threshold_byloss = threshold_byloss

    def __call__(self, ests, targets, return_ests: bool = False, **kwargs):
        if self.pit_from == "perm_avg":
            min_loss, batch_indices = self.best_perm_from_perm_avg_loss(
                self.loss_func, ests, targets, **kwargs)
            mean_loss = min_loss.mean()
        else:
            if self.pit_from == "pw_mtx":
                pw_loss = self.loss_func(ests, targets, **kwargs)
            else:
                pw_loss = self.get_pw_losses(self.loss_func, ests, targets, **kwargs)
            if pw_loss.ndim != 3 or pw_loss.shape[0] != targets.shape[0]:
                raise ValueError("pairwise loss must be [B, n_est, n_tgt]")
            min_loss, batch_indices = find_best_perm(pw_loss)
            mean_loss = min_loss.mean()
            if self.threshold_byloss:
                keep = min_loss > -30.0
                cnt = keep.sum()
                masked = torch.where(keep, min_loss, 0.0).sum() / torch.clamp(cnt, min=1)
                mean_loss = torch.where(cnt > 0, masked, mean_loss)
        if not return_ests:
            return mean_loss
        return mean_loss, reorder_sources(ests, batch_indices)

    @staticmethod
    def get_pw_losses(loss_func, ests, targets, **kwargs):
        """The pairwise matrix from a single-source loss (pw_pt mode)."""
        n_src = targets.shape[1]
        rows = [
            torch.stack([loss_func(ests[:, i], targets[:, j], **kwargs) for j in range(n_src)], dim=-1)
            for i in range(n_src)
        ]
        return torch.stack(rows, dim=1)  # [B, n_est, n_tgt]

    @staticmethod
    def best_perm_from_perm_avg_loss(loss_func, ests, targets, **kwargs):
        """perm_avg mode: the loss of each globally permuted estimate set."""
        perms, _ = _perm_tensors(targets.shape[1], ests.device)
        loss_set = torch.stack([loss_func(ests[:, p], targets, **kwargs) for p in perms], dim=1)
        min_loss, idx = loss_set.min(dim=1)
        return min_loss, perms[idx]
