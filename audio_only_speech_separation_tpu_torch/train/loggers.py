"""Experiment loggers (counterpart of
``audio_only_speech_separation_tpu/train/loggers.py``): CSV always,
TensorBoard through torch's SummaryWriter when it imports, Comet where the
``comet_ml`` package is installed."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class BaseLogger:
    def log_scalar(self, tag: str, value: float, step: int):
        raise NotImplementedError

    def log_histogram(self, tag: str, values, step: int):
        pass

    def log_embedding(self, tag: str, mat, metadata=None, step: int = 0):
        pass

    def log_text(self, tag: str, text: str, step: int = 0):
        pass

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
    """torch SummaryWriter in ``save_dir/name/version``; raises ImportError
    where tensorboard is missing."""

    def __init__(self, save_dir: str, name: str = "default", version: Optional[str] = None):
        from torch.utils.tensorboard import SummaryWriter

        self.log_dir = os.path.join(save_dir, name, version or "")
        os.makedirs(self.log_dir, exist_ok=True)
        self.writer = SummaryWriter(self.log_dir)

    def log_scalar(self, tag, value, step):
        self.writer.add_scalar(tag, value, step)

    def log_hyperparams(self, params):
        self.writer.add_hparams(
            {k: v for k, v in params.items() if isinstance(v, (int, float, str, bool))}, {})

    def close(self):
        self.writer.close()


class CometLogger(BaseLogger):
    """A ``comet_ml.Experiment`` (reference system/comet.py:58); the
    constructor imports ``comet_ml`` and raises ImportError without it."""

    def __init__(self, project_name: Optional[str] = None, **kwargs):
        import comet_ml

        self.experiment = comet_ml.Experiment(project_name=project_name, **kwargs)

    def log_scalar(self, tag, value, step):
        self.experiment.log_metric(tag, value, step=step)

    def log_histogram(self, tag, values, step):
        self.experiment.log_histogram_3d(values, name=tag, step=step)

    def log_embedding(self, tag, mat, metadata=None, step=0):
        self.experiment.log_embedding(mat, metadata, title=tag)

    def log_text(self, tag, text, step=0):
        self.experiment.log_text(text, metadata={"tag": tag, "step": step})

    def log_hyperparams(self, params):
        self.experiment.log_parameters(params)

    def close(self):
        self.experiment.end()


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
        loggers.append(TensorBoardLogger(log_dir, name=""))
    except ImportError:
        pass
    return CompositeLogger(loggers)


def make_logger(kind: str, log_dir: str, **kwargs) -> BaseLogger:
    """A logger by kind: "csv" (in ``log_dir``), "tensorboard" (in
    ``log_dir``, ``kwargs`` to ``TensorBoardLogger``; a ``CSVLogger`` there
    where tensorboard does not import, as the JAX function falls back: a
    choice of where scalars are written, not of a device or kernel) or
    "comet" (``kwargs`` to ``CometLogger``); ValueError for any other."""
    if kind == "csv":
        return CSVLogger(log_dir)
    if kind == "tensorboard":
        try:
            return TensorBoardLogger(log_dir, **kwargs)
        except ImportError:
            return CSVLogger(log_dir)
    if kind == "comet":
        return CometLogger(**kwargs)
    raise ValueError(f"unknown logger kind {kind!r}")
