"""Data layer (counterpart of ``audio_only_speech_separation_tpu/data``;
reference look2hear/datas/__init__.py:7-14): the manifest datasets and
datamodules that the configs in ``configs/`` name, and the threaded
loader.  numpy and the standard library only.

Not ported yet (ROADMAP Queue 1): ``wsj0.py``, ``extra_datasets.py``,
``sbdataset.py``, ``augment.py``, ``transform.py`` and the native wav
reader ``native.py``.
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
from .loader import DataLoader

__all__ = [
    "ManifestDataset",
    "LRS2Dataset",
    "LRS3Dataset",
    "Libri2MixDataset",
    "WhamDataset",
    "LRS2TwoStepDataset",
    "BaseDataModule",
    "LRS2DataModule",
    "LRS3DataModule",
    "Libri2MixDataModule",
    "WhamDataModule",
    "LRS2TwoStepDataModule",
    "DataLoader",
    "normalize_wav",
    "get",
]


def get(name):
    """String -> datamodule class; passthrough for classes."""
    if callable(name):
        return name
    obj = globals().get(name)
    if obj is None or name not in __all__:
        raise ValueError(f"Could not interpret datamodule identifier: {name}")
    return obj
