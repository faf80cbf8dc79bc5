"""JSON-manifest separation datasets (counterpart of
``audio_only_speech_separation_tpu/data/dataset.py``).

Contract (reference: look2hear/datas/lrs2datamodule.py:31-259): a manifest
dir holds ``<mix_name>.json`` + ``s1.json``… each a list of
``[wav_path, n_samples]`` pairs.  Training drops utterances shorter than
``segment × sample_rate`` and random-crops a window; ``segment=None`` puts
the dataset in test mode (full utterances, deterministic).  n_src=1 mode
flattens (mix, src) pairs for target-autoencoder pretraining; the two-step
variant returns (target, target).

Batch contract: ``(mixture [T], sources [n_src, T], key:str)``.  Crops are
drawn from ``(seed, epoch, item)``, so the same manifests give the same
batches here and in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .audio_io import read_wav

EPS = 1e-8


def normalize_wav(wav: np.ndarray, eps: float = EPS, std: Optional[np.ndarray] = None):
    """Zero-mean/unit-std along the last axis (reference lrs2datamodule.py:24-28)."""
    mean = wav.mean(-1, keepdims=True)
    if std is None:
        std = wav.std(-1, keepdims=True)
    return (wav - mean) / (std + eps)


def _read(path: str, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
    return read_wav(path, start, stop)


class ManifestDataset:
    """One parameterized class covers the LRS2/LRS3/Libri2Mix/WHAM variants
    (they differ only in manifest names and max n_src, SURVEY.md §2.3)."""

    mix_manifest = "mix.json"
    source_names: Sequence[str] = ("s1", "s2")
    max_n_src = 2
    two_step = False  # n_src=1 returns (target, target) when True

    def __init__(
        self,
        json_dir: str,
        n_src: int = 2,
        sample_rate: int = 8000,
        segment: Optional[float] = 4.0,
        normalize_audio: bool = False,
        seed: Optional[int] = None,
    ):
        if not json_dir:
            raise ValueError("JSON DIR is None!")
        if n_src not in range(1, self.max_n_src + 1):
            raise ValueError(f"{n_src} is not in [1, {self.max_n_src}]")
        self.json_dir = json_dir
        self.n_src = n_src
        self.sample_rate = sample_rate
        self.normalize_audio = normalize_audio
        self.seg_len = None if segment is None else int(segment * sample_rate)
        self.test = self.seg_len is None
        # crops are deterministic per (seed, epoch, item): reproducible
        # runs, the same crops as the JAX package's data layer, and the same
        # sample content whatever the device layout (an order-dependent
        # shared RNG would diverge between a 1×N and an M×(N/M) layout).
        # The reference's torch-worker crops are nondeterministic
        # (lrs2datamodule.py:157-164).
        self._seed = 0 if seed is None else seed
        self._epoch = 0

        with open(os.path.join(json_dir, self.mix_manifest)) as f:
            mix_infos = json.load(f)
        sources_infos = []
        for name in self.source_names[: max(n_src, 2) if n_src > 1 else len(self.source_names)]:
            path = os.path.join(json_dir, f"{name}.json")
            if n_src > 1 and not os.path.exists(path) and len(sources_infos) >= n_src:
                break
            with open(path) as f:
                sources_infos.append(json.load(f))
        if self.n_src > 1:
            sources_infos = sources_infos[: self.n_src]

        self.drop_utt = 0
        self.drop_len = 0
        if self.n_src == 1:
            # flatten (mix, src) pairs across all sources
            self.mix: List = []
            self.sources: List = []
            keep = range(len(mix_infos))
            for i in keep:
                if not self.test and mix_infos[i][1] < self.seg_len:
                    self.drop_utt += 1
                    self.drop_len += mix_infos[i][1]
                    continue
                for src_inf in sources_infos:
                    self.mix.append(mix_infos[i])
                    self.sources.append(src_inf[i])
        else:
            if not self.test:
                kept = [i for i in range(len(mix_infos)) if mix_infos[i][1] >= self.seg_len]
                self.drop_utt = len(mix_infos) - len(kept)
                self.drop_len = sum(
                    mix_infos[i][1] for i in range(len(mix_infos)) if i not in set(kept)
                )
                mix_infos = [mix_infos[i] for i in kept]
                sources_infos = [[s[i] for i in kept] for s in sources_infos]
            self.mix = mix_infos
            self.sources = sources_infos
        self.length = len(self.mix)

    def __len__(self):
        return self.length

    def set_epoch(self, epoch: int):
        """Advance the crop RNG stream (called via DataLoader.set_epoch)."""
        self._epoch = epoch

    def _window(self, n_samples: int, idx: int) -> Tuple[int, Optional[int]]:
        if self.test or n_samples == self.seg_len:
            return 0, None if self.test else self.seg_len
        rng = np.random.default_rng((self._seed, self._epoch, idx))
        start = int(rng.integers(0, n_samples - self.seg_len))
        return start, start + self.seg_len

    def __getitem__(self, idx: int):
        start, stop = self._window(self.mix[idx][1], idx)
        mixture = _read(self.mix[idx][0], start, stop)
        key = self.mix[idx][0].split("/")[-1]
        if self.n_src == 1:
            target = _read(self.sources[idx][0], start, stop)
            if self.normalize_audio:
                std = mixture.std(-1, keepdims=True)
                mixture = normalize_wav(mixture, std=std)
                target = normalize_wav(target, std=std)
            if self.two_step:
                return target, target[None, :], key
            return mixture, target[None, :], key
        srcs = np.stack(
            [_read(s[idx][0], start, stop) for s in self.sources], axis=0
        )
        if self.normalize_audio:
            std = mixture.std(-1, keepdims=True)
            mixture = normalize_wav(mixture, std=std)
            srcs = normalize_wav(srcs, std=std)
        return mixture, srcs, key


class LRS2Dataset(ManifestDataset):
    mix_manifest = "mix.json"
    source_names = ("s1", "s2")
    max_n_src = 2


class LRS3Dataset(ManifestDataset):
    mix_manifest = "mix_noise.json"
    source_names = ("s1", "s2", "s3")
    max_n_src = 3


class Libri2MixDataset(ManifestDataset):
    mix_manifest = "mix_clean.json"
    source_names = ("s1", "s2")
    max_n_src = 2


class WhamDataset(ManifestDataset):
    mix_manifest = "mix_both.json"
    source_names = ("s1", "s2")
    max_n_src = 2


class LRS2TwoStepDataset(LRS2Dataset):
    """Autoencoder pretraining: n_src=1 items are (target, target)
    (reference lrs2twostepdatamodule.py:154)."""

    two_step = True
