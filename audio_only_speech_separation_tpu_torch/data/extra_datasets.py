"""The other dataset variants (counterpart of
``audio_only_speech_separation_tpu/data/extra_datasets.py``; reference
look2hear/datas/, not exported there).

- ``MixITDataset``: mixtures of mixtures for unsupervised MixIT training
  (reference mixit_dataset.py:26-124, which is unfinished: it stops in
  ``pdb.set_trace()`` and calls ``np.vstack`` wrongly; this is what it
  means to do, as the JAX package has it).
- ``AudioSlientDataset``: the wsj0 items with ``slient`` seconds of
  silence, or Gaussian noise, before the mixture and the sources
  (reference audio_dataset_slient.py:23-163; its live code prepends zeros,
  :157-163).
- ``AVSpeechDataset``: audio-visual items with mouth-ROI .npz streams
  (reference avspeech_dataset.py:26-202).  The reference preprocesses the
  frames with opencv; the JAX package and this port do it in numpy
  (``transform.py``), so nothing here imports opencv.

Random draws come from (seed, epoch, item), as the crops do, so the same
manifests give the JAX package's items.
"""

from __future__ import annotations

import numpy as np

from .audio_io import read_wav
from .dataset import ManifestDataset, normalize_wav
from .wsj0 import WSJ0Dataset


class MixITDataset(WSJ0Dataset):
    """Returns (mixture, sources [n_src, T], moms [2, T], key): ``moms`` are
    two mixtures of mixtures from a random equal split of the sources
    (reference intent at mixit_dataset.py:107-116)."""

    def __getitem__(self, idx: int):
        mixture, sources, key = super().__getitem__(idx)
        n = sources.shape[0]
        perm = np.random.default_rng((self._seed, self._epoch, idx, 1)).permutation(n)
        half = n // 2
        moms = np.stack([sources[perm[:half]].sum(0), sources[perm[half:]].sum(0)], 0)
        if self.normalize_audio:
            std = mixture.std(-1, keepdims=True)
            moms = normalize_wav(moms, std=std)
        return mixture, sources, moms, key


class AudioSlientDataset(WSJ0Dataset):
    """Prepends ``slient`` seconds of silence (or of Gaussian noise at
    ``snr_db``) to every item."""

    def __init__(self, json_dir: str, n_src: int = 2, gauss: bool = False,
                 slient: float = 2.0, snr_db: float = -30.0, **kw):
        super().__init__(json_dir, n_src=n_src, **kw)
        self.gauss = gauss
        self.slient = slient
        self.snr_db = snr_db

    def __getitem__(self, idx: int):
        mixture, sources, key = super().__getitem__(idx)
        n_pad = int(self.sample_rate * self.slient)
        if self.gauss:
            scale = 10.0 ** (self.snr_db / 20.0)
            rng = np.random.default_rng((self._seed, self._epoch, idx, 2))
            pad = (rng.normal(size=n_pad) * scale).astype(np.float32)
        else:
            pad = np.zeros(n_pad, np.float32)
        mixture = np.concatenate([pad, mixture])
        sources = np.stack([np.concatenate([pad, s]) for s in sources], 0)
        return mixture, sources, key


class AVSpeechDataset(ManifestDataset):
    """Audio-visual items: (mixture, sources, mouths [n_src, F, 88, 88], key).

    Source manifests hold (wav_path, mouth_npz_path, n_samples) triples
    (reference avspeech_dataset.py:125-187)."""

    mix_manifest = "mix.json"
    source_names = ("s1", "s2")
    max_n_src = 2

    def __init__(self, json_dir: str, fps: int = 25, **kw):
        super().__init__(json_dir, **kw)
        self.fps = fps
        self.fps_len = None if self.seg_len is None else int(self.seg_len / self.sample_rate * fps)
        from .transform import get_preprocessing_pipelines

        self.video_pipeline = get_preprocessing_pipelines()["train" if not self.test else "val"]

    def _load_mouth(self, npz_path: str, frame_start: int):
        data = np.load(npz_path)["data"]
        if self.fps_len is not None:
            data = data[frame_start : frame_start + self.fps_len]
        return self.video_pipeline(data)

    def __getitem__(self, idx: int):
        start, stop = self._window(self.mix[idx][1], idx)
        frame_start = int(start / self.sample_rate * self.fps)
        mixture = read_wav(self.mix[idx][0], start, stop)
        key = self.mix[idx][0].split("/")[-1]
        srcs, mouths = [], []
        for s in self.sources:
            entry = s[idx]
            srcs.append(read_wav(entry[0], start, stop))
            mouths.append(self._load_mouth(entry[1], frame_start))
        sources = np.stack(srcs, 0)
        mouth_arr = np.stack(mouths, 0)
        if self.normalize_audio:
            std = mixture.std(-1, keepdims=True)
            mixture = normalize_wav(mixture, std=std)
            sources = normalize_wav(sources, std=std)
        return mixture, sources, mouth_arr, key
