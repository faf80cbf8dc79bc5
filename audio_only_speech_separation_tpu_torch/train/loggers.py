"""Experiment loggers (counterpart of
``audio_only_speech_separation_tpu/train/loggers.py``): CSV always,
TensorBoard through torch's SummaryWriter when it imports."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class BaseLogger:
    def log_scalar(self, tag: str, value: float, step: int):
        raise NotImplementedError

    def log_hyperparams(self, params: Dict[str, Any]):
        pass

    def close(self):
        pass


class CSVLogger(BaseLogger):
    """``scalars.csv`` (step, tag, value) and ``hparams.json`` in log_dir."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "scalars.csv")
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                f.write("step,tag,value\n")
        self.hparams_path = os.path.join(log_dir, "hparams.json")

    def log_scalar(self, tag, value, step):
        with open(self.path, "a") as f:
            f.write(f"{step},{tag},{value}\n")

    def log_hyperparams(self, params):
        with open(self.hparams_path, "w") as f:
            json.dump(params, f, indent=2, default=str)


class TensorBoardLogger(BaseLogger):
    """torch SummaryWriter; raises ImportError where tensorboard is missing."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir)

    def log_scalar(self, tag, value, step):
        self.writer.add_scalar(tag, value, step)

    def log_hyperparams(self, params):
        self.writer.add_hparams(
            {k: v for k, v in params.items() if isinstance(v, (int, float, str, bool))}, {})

    def close(self):
        self.writer.close()


class CompositeLogger(BaseLogger):
    """Fan-out to several loggers."""

    def __init__(self, loggers):
        self.loggers = list(loggers)

    def log_scalar(self, tag, value, step):
        for lg in self.loggers:
            lg.log_scalar(tag, value, step)

    def log_hyperparams(self, params):
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def close(self):
        for lg in self.loggers:
            lg.close()


def make_default_logger(log_dir: str) -> BaseLogger:
    """CSV always, TensorBoard when it imports."""
    loggers: list = [CSVLogger(log_dir)]
    try:
        loggers.append(TensorBoardLogger(log_dir))
    except ImportError:
        pass
    return CompositeLogger(loggers)
