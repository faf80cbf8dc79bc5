"""Training-time augmentation (counterpart of
``audio_only_speech_separation_tpu/data/augment.py``; reference
look2hear/system/core.py:170-189).

``online_mixing_collate`` re-mixes the sources within a batch: each source
slot is permuted across the batch and energy-matched to the source it
replaces, and the new mixture is their sum (dynamic mixing without more
reads).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def online_mixing_collate(
    inputs: np.ndarray,  # [B, T]: unused but for the signature's parity
    targets: np.ndarray,  # [B, n_src, T]
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (new mixtures [B, T], new targets [B, n_src, T])."""
    rng = rng or np.random.default_rng()
    B, n_src, T = targets.shape
    energies = np.sum(targets**2, axis=-1, keepdims=True)  # [B, n_src, 1]
    new_src = []
    for i in range(n_src):
        perm = rng.permutation(B)
        s = targets[perm, i, :]
        s_energy = np.sum(s**2, axis=-1, keepdims=True) + 1e-12
        s = s * np.sqrt(energies[:, i] / s_energy)
        new_src.append(s)
    new_targets = np.stack(new_src, axis=1).astype(targets.dtype)
    return new_targets.sum(1), new_targets
