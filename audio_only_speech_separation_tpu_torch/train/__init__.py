"""Training system (counterpart of ``audio_only_speech_separation_tpu/train``;
reference look2hear/system/__init__.py:9-12)."""

from .checkpoints import CheckpointManager
from .loggers import CompositeLogger, CSVLogger, TensorBoardLogger, make_default_logger
from .optimizers import get_learning_rate, make_optimizer, set_learning_rate
from .schedulers import CosineAnnealingLR, ExponentialLR, NoamLR, ReduceLROnPlateau, StepLR, make_scheduler
from .system import AudioLightningModule, AudioSystem
from .trainer import EarlyStopping, Trainer, bf16_forward

__all__ = [
    "make_optimizer",
    "get_learning_rate",
    "set_learning_rate",
    "make_scheduler",
    "ReduceLROnPlateau",
    "StepLR",
    "ExponentialLR",
    "CosineAnnealingLR",
    "NoamLR",
    "CheckpointManager",
    "AudioSystem",
    "AudioLightningModule",
    "EarlyStopping",
    "Trainer",
    "bf16_forward",
    "CSVLogger",
    "TensorBoardLogger",
    "CompositeLogger",
    "make_default_logger",
]
