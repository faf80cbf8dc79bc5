"""wsj0-mix raw dataset (counterpart of
``audio_only_speech_separation_tpu/data/wsj0.py``; reference
look2hear/datas/audio_dataset.py:24-127).

The reference exports ``WSJ0DataModule`` as a raw Dataset with no
``setup()``/``make_loader``, so its train CLI cannot use it; the JAX
package, and this port, keep the name and give it the full datamodule
contract.
"""

from __future__ import annotations

import numpy as np

from .datamodules import BaseDataModule
from .dataset import ManifestDataset, _read, normalize_wav


class WSJ0Dataset(ManifestDataset):
    """mix.json + s1..sN; a missing source fills with zeros
    (audio_dataset.py:110-115)."""

    mix_manifest = "mix.json"
    max_n_src = 4

    def __init__(self, json_dir: str, n_src: int = 2, **kw):
        self.source_names = tuple(f"s{i+1}" for i in range(n_src))
        super().__init__(json_dir, n_src=n_src, **kw)

    def __getitem__(self, idx: int):
        start, stop = self._window(self.mix[idx][1], idx)
        mixture = _read(self.mix[idx][0], start, stop)
        key = self.mix[idx][0].split("/")[-1]
        srcs = []
        for s in self.sources:
            if s[idx] is None:
                srcs.append(np.zeros(len(mixture), np.float32))
            else:
                srcs.append(_read(s[idx][0], start, stop))
        sources = np.stack(srcs, 0)
        if self.normalize_audio:
            std = mixture.std(-1, keepdims=True)
            mixture = normalize_wav(mixture, std=std)
            sources = normalize_wav(sources, std=std)
        return mixture, sources, key


class WSJ0DataModule(BaseDataModule):
    dataset_cls = WSJ0Dataset
