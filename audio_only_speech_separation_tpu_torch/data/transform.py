"""Video-frame preprocessing of the audio-visual dataset (counterpart of
``audio_only_speech_separation_tpu/data/transform.py``; reference
look2hear/datas/transform.py:1-167).

numpy only: crops, flips and normalisation need no opencv, and grayscale
is the ITU-R 601 luminance.  The pipelines: train = RgbToGray ->
Normalize(0, 255) -> RandomCrop(88) -> HorizontalFlip(0.5) ->
Normalize(mean 0.421, std 0.165); val and test take CenterCrop in place of
the random operations (transform.py:151-167).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = transforms

    def __call__(self, frames):
        for t in self.transforms:
            frames = t(frames)
        return frames


class RgbToGray:
    def __call__(self, frames):  # [T, H, W, 3], or already gray [T, H, W]
        if frames.ndim == 4 and frames.shape[-1] == 3:
            w = np.array([0.299, 0.587, 0.114], frames.dtype if frames.dtype.kind == "f" else np.float32)
            return np.tensordot(frames.astype(np.float32), w, axes=([-1], [0]))
        return frames


class Normalize:
    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, frames):
        return (frames.astype(np.float32) - self.mean) / self.std


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, frames):  # [T, H, W]
        h, w = frames.shape[1:3]
        th, tw = self.size
        dh, dw = (h - th) // 2, (w - tw) // 2
        return frames[:, dh : dh + th, dw : dw + tw]


class RandomCrop:
    def __init__(self, size: Tuple[int, int], rng=None):
        self.size = size
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames):
        h, w = frames.shape[1:3]
        th, tw = self.size
        dh = int(self.rng.integers(0, h - th + 1))
        dw = int(self.rng.integers(0, w - tw + 1))
        return frames[:, dh : dh + th, dw : dw + tw]


class HorizontalFlip:
    def __init__(self, flip_ratio: float = 0.5, rng=None):
        self.flip_ratio = flip_ratio
        self.rng = rng or np.random.default_rng()

    def __call__(self, frames):
        if self.rng.random() < self.flip_ratio:
            return frames[:, :, ::-1]
        return frames


def get_preprocessing_pipelines(crop_size=(88, 88), mean=0.421, std=0.165):
    """The LRW-style mouth-ROI pipelines (reference transform.py:151-167)."""
    val = Compose([RgbToGray(), Normalize(0.0, 255.0), CenterCrop(crop_size), Normalize(mean, std)])
    return {
        "train": Compose([RgbToGray(), Normalize(0.0, 255.0), RandomCrop(crop_size), HorizontalFlip(0.5),
                          Normalize(mean, std)]),
        "val": val,
        "test": Compose(list(val.transforms)),
    }
