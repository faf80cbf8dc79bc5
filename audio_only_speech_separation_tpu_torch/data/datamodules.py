"""DataModules (counterpart of
``audio_only_speech_separation_tpu/data/datamodules.py``): the reference's
3-loader contract over manifest datasets.

API parity (reference lrs2datamodule.py:262-372): ``setup()``,
``.make_loader`` → (train, val, test) loaders, ``.make_sets`` → raw
datasets.  One parameterized base covers all five variants.
"""

from __future__ import annotations

from typing import Optional, Type

from .dataset import (
    Libri2MixDataset,
    LRS2Dataset,
    LRS2TwoStepDataset,
    LRS3Dataset,
    ManifestDataset,
    WhamDataset,
)
from .loader import DataLoader


class BaseDataModule:
    dataset_cls: Type[ManifestDataset] = LRS2Dataset

    def __init__(
        self,
        train_dir: str,
        valid_dir: str,
        test_dir: str,
        n_src: int = 2,
        sample_rate: int = 8000,
        fps: int = 25,  # accepted for config parity (audio-visual frame rate)
        segment: float = 4.0,
        normalize_audio: bool = False,
        batch_size: int = 64,
        num_workers: int = 0,
        pin_memory: bool = False,  # accepted for config parity; no-op here
        persistent_workers: bool = False,  # config parity; loader is threaded
        audio_only: bool = True,
        shard_id: int = 0,
        num_shards: int = 1,
        seed: int = 0,
    ):
        if train_dir is None or valid_dir is None or test_dir is None:
            raise ValueError("JSON DIR is None!")
        self.train_dir = train_dir
        self.valid_dir = valid_dir
        self.test_dir = test_dir
        self.n_src = n_src
        self.sample_rate = sample_rate
        self.segment = segment
        self.normalize_audio = normalize_audio
        self.batch_size = batch_size
        self.num_workers = num_workers or 4
        self.audio_only = audio_only
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.data_train: Optional[ManifestDataset] = None
        self.data_val: Optional[ManifestDataset] = None
        self.data_test: Optional[ManifestDataset] = None

    def setup(self) -> None:
        kw = dict(
            n_src=self.n_src,
            sample_rate=self.sample_rate,
            segment=self.segment,
            normalize_audio=self.normalize_audio,
        )
        self.data_train = self.dataset_cls(self.train_dir, seed=self.seed, **kw)
        self.data_val = self.dataset_cls(self.valid_dir, seed=self.seed + 1, **kw)
        self.data_test = self.dataset_cls(self.test_dir, seed=self.seed + 2, **kw)

    def train_dataloader(self) -> DataLoader:
        return DataLoader(
            self.data_train,
            batch_size=self.batch_size,
            shuffle=True,
            drop_last=True,
            num_workers=self.num_workers,
            seed=self.seed,
            shard_id=self.shard_id,
            num_shards=self.num_shards,
        )

    def val_dataloader(self) -> DataLoader:
        # drop_last=False: eval must score every utterance (the tail batch
        # is weighted by size in the Trainer's epoch mean); host-sharded so
        # multi-host runs split the work instead of repeating it
        return DataLoader(
            self.data_val,
            batch_size=self.batch_size,
            shuffle=False,
            drop_last=False,
            num_workers=self.num_workers,
            shard_id=self.shard_id,
            num_shards=self.num_shards,
        )

    def test_dataloader(self) -> DataLoader:
        return DataLoader(
            self.data_test,
            batch_size=self.batch_size,
            shuffle=False,
            drop_last=False,
            num_workers=self.num_workers,
            shard_id=self.shard_id,
            num_shards=self.num_shards,
        )

    @property
    def make_loader(self):
        return self.train_dataloader(), self.val_dataloader(), self.test_dataloader()

    @property
    def make_sets(self):
        return self.data_train, self.data_val, self.data_test


class LRS2DataModule(BaseDataModule):
    dataset_cls = LRS2Dataset


class LRS3DataModule(BaseDataModule):
    dataset_cls = LRS3Dataset


class Libri2MixDataModule(BaseDataModule):
    dataset_cls = Libri2MixDataset


class WhamDataModule(BaseDataModule):
    dataset_cls = WhamDataset


class LRS2TwoStepDataModule(BaseDataModule):
    dataset_cls = LRS2TwoStepDataset
