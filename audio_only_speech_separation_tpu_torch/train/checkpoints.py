"""Checkpointing: top-k, last, and the portable best model, with auto-resume
(counterpart of ``audio_only_speech_separation_tpu/train/checkpoints.py``).

The experiment directory holds (reference audio_train.py:95-148):

- ``epoch=N.ckpt``: the top-k training states (model and optimizer state,
  epoch, scheduler and early-stop state, config) ranked by the monitored
  metric;
- ``last.ckpt``: the latest state, which ``maybe_resume`` restores;
- ``best_k_models.json``: the monitor score of each top-k file;
- ``best_model.pth``: written by the trainer through ``models.serialize``.

A state is pickled with its tensors moved to the CPU; unpickle only files
this package wrote.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitor: str = "val_loss", mode: str = "min",
                 save_top_k: int = 5, save_last: bool = True, filename: str = "epoch={epoch}"):
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.filename = filename
        os.makedirs(ckpt_dir, exist_ok=True)
        self.best_k: Dict[str, float] = {}

    def _path(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, self.filename.format(epoch=epoch) + ".ckpt")

    @property
    def last_path(self) -> str:
        return os.path.join(self.ckpt_dir, "last.ckpt")

    def _worst(self) -> Tuple[Optional[str], Optional[float]]:
        if not self.best_k:
            return None, None
        sel = max if self.mode == "min" else min
        path = sel(self.best_k, key=self.best_k.get)
        return path, self.best_k[path]

    def _better(self, a: float, b: float) -> bool:
        return a < b if self.mode == "min" else a > b

    def save(self, state: Dict[str, Any], epoch: int, metric: float) -> None:
        """Save a candidate checkpoint; evict the worst beyond top-k."""
        state = dict(state, epoch=epoch, monitor={self.monitor: float(metric)})
        blob = pickle.dumps(_to_cpu(state))
        if self.save_last:
            with open(self.last_path, "wb") as f:
                f.write(blob)
        if self.save_top_k == 0:
            return
        _, worst_metric = self._worst()
        if len(self.best_k) < self.save_top_k or self._better(metric, worst_metric):
            path = self._path(epoch)
            with open(path, "wb") as f:
                f.write(blob)
            self.best_k[path] = float(metric)
            if len(self.best_k) > self.save_top_k:
                worst_path, _ = self._worst()
                self.best_k.pop(worst_path)
                if os.path.exists(worst_path):
                    os.remove(worst_path)
        self.write_best_k()

    @property
    def best_path(self) -> Optional[str]:
        if not self.best_k:
            return None
        sel = min if self.mode == "min" else max
        return sel(self.best_k, key=self.best_k.get)

    def write_best_k(self) -> None:
        with open(os.path.join(self.ckpt_dir, "best_k_models.json"), "w") as f:
            json.dump(self.best_k, f, indent=0)

    def load(self, path: Optional[str] = None) -> Dict[str, Any]:
        with open(path or self.best_path, "rb") as f:
            return pickle.load(f)

    def maybe_resume(self) -> Optional[Dict[str, Any]]:
        """Auto-resume: the state in last.ckpt, if there is one, with the
        top-k map read back from best_k_models.json."""
        if not os.path.exists(self.last_path):
            return None
        state = self.load(self.last_path)
        bk = os.path.join(self.ckpt_dir, "best_k_models.json")
        if os.path.exists(bk):
            with open(bk) as f:
                self.best_k = {k: float(v) for k, v in json.load(f).items()}
        return state
