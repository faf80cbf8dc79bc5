"""The training loop on one device (counterpart of
``audio_only_speech_separation_tpu/train/trainer.py``): what Lightning did
for the reference, written out.

- f32 master weights.  ``precision="float32"`` runs the module;
  ``"bfloat16"`` is the JAX Trainer's mixed precision (its
  ``trainer.py:163-178``): the module runs through
  ``torch.func.functional_call`` on bf16 casts of its f32 parameters and
  of the mix, forward and backward in bf16, the gradients reach the f32
  parameters through the casts, and the estimate is cast to f32 before
  the loss.  That forward is the one ``serve`` runs on the module's bf16
  copy, so on the card the attention and LSTM layers take the kernels K4,
  K5 and K6 (their backwards recompute through the plain versions).  With
  ``fused_forward=True`` a ConvTasNet instead runs
  ``models.convtasnet.make_kernel_train_apply`` on the same casts (the TCN
  chain through its forward and backward kernels).
- Dropout and DropPath draw from their own generators, seeded from
  ``seed`` once before the first step (``ops.dropout.seed_generators``).
- Global-norm gradient clipping happens in the optimizer's ``step``.
- ReduceLROnPlateau (per epoch, on the val loss) or Noam (per step), and
  EarlyStopping on the val loss.
- CheckpointManager: top-k, last.ckpt with auto-resume, best_k_models.json,
  and best_model.pth in the ``models.serialize`` layout.
- Scalars train_loss / val_loss / val_pit_sisnr / test_loss /
  test_pit_sisnr / learning_rate (reference audio_litmodule.py:79-148).

Validation runs every epoch, the test loader every ``TEST_EVERY`` epochs
(reference audio_litmodule.py:109-123).  The device is the CUDA card
unless the caller passes ``device="cpu"``; there is no quiet fallback.
Data-parallel and multi-host training are not ported yet.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..models import save_serialized, serialize
from ..ops.dropout import seed_generators
from .checkpoints import CheckpointManager
from .loggers import BaseLogger, make_default_logger
from .optimizers import get_learning_rate, set_learning_rate
from .schedulers import NoamLR

TEST_EVERY = 10  # epochs between runs of the test loader


class EarlyStopping:
    """monitor/mode/patience state machine (reference audio_train.py:106-108)."""

    def __init__(self, monitor="val_loss", mode="min", patience=30, verbose=False, **_):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.verbose = verbose
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        better = self.best is None or (metric < self.best if self.mode == "min" else metric > self.best)
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience

    def state_dict(self):
        return dict(self.__dict__)

    def load_state_dict(self, state):
        self.__dict__.update(state)


class Trainer:
    def __init__(self, exp_dir: str, epochs: int = 500, early_stop: Optional[dict] = None,
                 logger_dir: Optional[str] = None, checkpoint: Optional[dict] = None,
                 precision: str = "float32", seed: int = 42,
                 logger: Optional[BaseLogger] = None, fused_forward: bool = False, device="cuda"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be float32 or bfloat16, got {precision!r}")
        self.exp_dir = exp_dir
        self.epochs = epochs
        self.precision = precision
        self.seed = seed  # the dropout masks' seed (the JAX Trainer's default)
        # opt-in: bf16 training through the TCN chain's kernels
        self.fused_forward = fused_forward
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device=\"cpu\" to train on the CPU")
        es = dict(early_stop or {})
        es.setdefault("monitor", "val_loss/dataloader_idx_0")
        self.early_stop = EarlyStopping(**es)
        ck = dict(checkpoint or {})
        ck.setdefault("monitor", "val_loss/dataloader_idx_0")
        self.ckpt = CheckpointManager(os.path.join(exp_dir, ""), **{
            k: v for k, v in ck.items()
            if k in ("monitor", "mode", "save_top_k", "save_last", "filename")})
        self.logger = logger or make_default_logger(logger_dir or os.path.join(exp_dir, "logs"))

    def _make_forward(self, model):
        """est = forward(mix) in f32, by ``precision`` and ``fused_forward``."""
        if self.precision == "float32":
            return model
        bf = torch.bfloat16
        params = dict(model.named_parameters())
        apply_fn = None
        if self.fused_forward:
            from ..models.convtasnet import ConvTasNet, make_kernel_train_apply

            if isinstance(model, ConvTasNet):
                apply_fn = make_kernel_train_apply(model)

        def forward(mix):
            cast = {k: p.to(bf) if p.dtype == torch.float32 else p for k, p in params.items()}
            if apply_fn is not None:
                return apply_fn(cast, mix.to(bf)).float()
            return torch.func.functional_call(model, cast, (mix.to(bf),)).float()

        return forward

    def _batch(self, np_batch):
        mix, sources, _keys = np_batch
        return (torch.from_numpy(np.asarray(mix)).to(self.device),
                torch.from_numpy(np.asarray(sources)).to(self.device))

    def _eval_epoch(self, forward, loss_func, loader) -> float:
        """Batch-size-weighted mean loss over a loader (one host sync)."""
        tot, wsum = None, 0
        with torch.no_grad():
            for b in loader:
                mix, sources = self._batch(b)
                loss = loss_func(forward(mix), sources) * len(mix)
                tot = loss if tot is None else tot + loss
                wsum += len(mix)
        return float("nan") if tot is None else float(tot) / wsum

    def fit(self, system):
        """Train ``system`` (resuming from last.ckpt when there is one);
        returns the trained module."""
        model = system.audio_model.to(self.device)
        opt = system.optimizer
        scheduler = system.scheduler
        train_loss_fn, val_loss_fn = system.loss_func["train"], system.loss_func["val"]

        start_epoch = 0
        resume = self.ckpt.maybe_resume()
        if resume is not None:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in resume["model"].items()})
            opt.load_state_dict(resume["optimizer"])
            start_epoch = resume["epoch"] + 1
            if scheduler is not None and resume.get("scheduler"):
                scheduler.load_state_dict(resume["scheduler"])
            if resume.get("early_stop"):
                self.early_stop.load_state_dict(resume["early_stop"])
        forward = self._make_forward(model)
        seed_generators(model, self.seed)
        self.logger.log_hyperparams(getattr(system, "hparams", None) or {})

        current_lr = getattr(scheduler, "lr", None)
        for epoch in range(start_epoch, self.epochs):
            t0 = time.time()
            model.train()
            system.train_loader.set_epoch(epoch)
            loss_sum, nseen = None, 0
            for np_batch in system.train_loader:
                mix, sources = self._batch(np_batch)
                opt.zero_grad()
                loss = train_loss_fn(forward(mix), sources)
                loss.backward()
                opt.step()
                if isinstance(scheduler, NoamLR):
                    current_lr = scheduler.step_batch()
                    set_learning_rate(opt, current_lr)
                loss = loss.detach() * len(mix)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                nseen += len(mix)
            train_loss = float(loss_sum) / nseen if loss_sum is not None else float("nan")

            model.eval()
            val_loss = self._eval_epoch(forward, val_loss_fn, system.val_loader)
            test_loss = None
            if system.test_loader is not None and epoch % TEST_EVERY == 0:
                test_loss = self._eval_epoch(forward, val_loss_fn, system.test_loader)

            if scheduler is not None and not isinstance(scheduler, NoamLR):
                current_lr = scheduler.step(val_loss)
                set_learning_rate(opt, current_lr)
            self.logger.log_scalar("train_loss", train_loss, epoch)
            self.logger.log_scalar("val_loss", val_loss, epoch)
            self.logger.log_scalar("val_pit_sisnr", -val_loss, epoch)
            if test_loss is not None:
                self.logger.log_scalar("test_loss", test_loss, epoch)
                self.logger.log_scalar("test_pit_sisnr", -test_loss, epoch)
            self.logger.log_scalar("learning_rate", get_learning_rate(opt), epoch)
            print(f"epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f}"
                  + (f" test_loss={test_loss:.4f}" if test_loss is not None else "")
                  + (f" lr={current_lr:.2e}" if current_lr is not None else "")
                  + f" ({time.time() - t0:.1f}s)")

            self.ckpt.save({
                "model": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
                "optimizer": opt.state_dict(),
                "scheduler": scheduler.state_dict() if scheduler else None,
                "early_stop": self.early_stop.state_dict(),
                "config": getattr(system, "config", None),
            }, epoch, val_loss)
            if self.early_stop.step(val_loss):
                break

        # the portable best model (reference audio_train.py:139-148)
        self.ckpt.write_best_k()
        if self.ckpt.best_k:
            best = self.ckpt.load()
            save_serialized(serialize(model, state_dict=best["model"]),
                            os.path.join(self.exp_dir, "best_model.pth"))
        self.logger.close()
        return model
