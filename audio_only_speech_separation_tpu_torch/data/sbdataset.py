"""SpeechBrain CSV dataset (counterpart of
``audio_only_speech_separation_tpu/data/sbdataset.py``; reference
look2hear/datas/sbdataset.py).

The reference wraps SpeechBrain's DynamicItemDataset and PaddedBatch; the
same CSV contract (id, duration, mix_wav, s<i>_wav columns) is read here
with numpy, so speechbrain is needed only by ``as_speechbrain()``, which
imports it when called.
"""

from __future__ import annotations

import csv
from typing import List, Optional

import numpy as np

from .audio_io import read_wav


class SBAudioDataset:
    """CSV manifest: columns id, duration, mix_wav, s1_wav, s2_wav, ..."""

    def __init__(self, csv_path: str, n_src: int = 2, sample_rate: int = 8000,
                 segment: Optional[float] = None, seed: int = 0):
        self.csv_path = csv_path
        self.n_src = n_src
        self.sample_rate = sample_rate
        self.seg_len = None if segment is None else int(segment * sample_rate)
        self._rng = np.random.default_rng(seed)
        with open(csv_path) as f:
            self.rows: List[dict] = list(csv.DictReader(f))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int):
        row = self.rows[idx]
        mix = read_wav(row["mix_wav"])
        if self.seg_len is not None and len(mix) > self.seg_len:
            start = int(self._rng.integers(0, len(mix) - self.seg_len))
            stop = start + self.seg_len
        else:
            start, stop = 0, None
        mix = mix[start:stop]
        srcs = np.stack([read_wav(row[f"s{i + 1}_wav"])[start:stop] for i in range(self.n_src)], 0)
        return mix, srcs, row.get("id", str(idx))

    def as_speechbrain(self):  # pragma: no cover - needs the optional speechbrain
        import speechbrain  # noqa: F401
        from speechbrain.dataio.dataset import DynamicItemDataset

        return DynamicItemDataset.from_csv(self.csv_path)
