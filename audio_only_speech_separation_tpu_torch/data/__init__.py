"""Data layer (counterpart of ``audio_only_speech_separation_tpu/data``;
reference look2hear/datas/__init__.py:7-14): the manifest datasets and
datamodules that the configs in ``configs/`` name, the threaded loader,
the native wav reader (``native.py``), the other dataset variants
(``extra_datasets.py``, ``sbdataset.py``), online mixing
(``augment.py``) and the video pipelines (``transform.py``).  numpy, the
standard library and the repository's own C++ reader only.
"""

from .datamodules import (
    BaseDataModule,
    Libri2MixDataModule,
    LRS2DataModule,
    LRS2TwoStepDataModule,
    LRS3DataModule,
    WhamDataModule,
)
from .dataset import (
    Libri2MixDataset,
    LRS2Dataset,
    LRS2TwoStepDataset,
    LRS3Dataset,
    ManifestDataset,
    WhamDataset,
    normalize_wav,
)
from .extra_datasets import AudioSlientDataset, AVSpeechDataset, MixITDataset
from .loader import DataLoader
from .transform import get_preprocessing_pipelines
from .wsj0 import WSJ0DataModule, WSJ0Dataset

__all__ = [
    "ManifestDataset",
    "LRS2Dataset",
    "LRS3Dataset",
    "Libri2MixDataset",
    "WhamDataset",
    "LRS2TwoStepDataset",
    "WSJ0Dataset",
    "BaseDataModule",
    "LRS2DataModule",
    "LRS3DataModule",
    "Libri2MixDataModule",
    "WhamDataModule",
    "LRS2TwoStepDataModule",
    "WSJ0DataModule",
    "DataLoader",
    "normalize_wav",
    "MixITDataset",
    "AudioSlientDataset",
    "AVSpeechDataset",
    "get_preprocessing_pipelines",
]


def get(name):
    """String -> datamodule class (reference getattr reflection);
    passthrough for classes."""
    if callable(name):
        return name
    obj = globals().get(name)
    if obj is None or name not in __all__:
        raise ValueError(f"Could not interpret datamodule identifier: {name}")
    return obj
