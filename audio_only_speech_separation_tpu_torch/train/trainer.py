"""The training loop (counterpart of
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
- Data parallel: under a process group (``parallel.init_distributed``,
  one process a card) the train forward runs under
  ``DistributedDataParallel`` over the ``dp`` mesh, each rank on its own
  shard of the global batch (the loaders trim the shards to equal
  lengths).  So the loss is the mean over the global batch and the
  gradient its gradient, as in the JAX Trainer's step, and the global-norm
  clip in the optimizer's ``step`` reads the reduced gradients.  The
  logged train loss and every evaluation are reduced across the ranks
  (Σ loss·n, Σ n), so each rank takes the same scheduler and early-stop
  decisions.  Rank 0 alone writes checkpoints, best_k_models.json,
  best_model.pth, the logs and the epoch lines; every rank resumes from
  the same last.ckpt.
- Sequence parallel: with ``sp`` > 1 the ranks form a (dp, sp) mesh
  (``parallel.make_mesh``), the ranks of one ``sp`` group train on the same
  shard of the data (the ``dp`` coordinate's) and share each sample's
  chunks in the dual-path models and BSRNN (``parallel/sequence.py``).
  Each rank's gradients are then partial (the train forward gives each
  rank 1 / sp of its replicated output's gradient), and DDP runs over every
  rank with a reduction that sums them over ``sp`` and averages over
  ``dp``, so the update is the one process's on the ``dp`` shards.
  Evaluation runs the whole model on each rank's ``dp`` shard, as without
  ``sp``; the reduced means count each shard ``sp`` times above and below.
- Dropout and DropPath draw from their own generators, seeded from
  (``seed``, global step, ``dp`` coordinate: the rank without ``sp``) at
  the start of every step's forward
  (``ops.dropout.seed_generators``), as the JAX Trainer folds the step into
  its key: a run resumed from last.ckpt (which keeps the global step)
  draws the masks of the uninterrupted run.
- ``remat=True`` recomputes the train forward's activations in the
  backward (``torch.utils.checkpoint``, non-reentrant; the JAX Trainer's
  ``jax.checkpoint``), and the recomputed forward reseeds its masks, so it
  draws the first pass's.  On the fused ConvTasNet path it does nothing,
  as in the JAX Trainer, whose fused path bypasses its checkpoint.
- A warm start: ``system.warm_start = (pretrained state dict, merge_fn)``
  calls ``merge_fn(model, pretrained)`` before the first step of a run that
  does not resume (``audio_train_twostep.update_parameter``).
- ReduceLROnPlateau (per epoch, on the val loss) or Noam (per step), and
  EarlyStopping on the val loss.
- CheckpointManager: top-k, last.ckpt with auto-resume, best_k_models.json,
  and best_model.pth in the ``models.serialize`` layout.
- Scalars train_loss / val_loss / val_pit_sisnr / test_loss /
  test_pit_sisnr / learning_rate (reference audio_litmodule.py:79-148).

Validation runs every epoch, the test loader every ``TEST_EVERY`` epochs
(reference audio_litmodule.py:109-123).  The device is the CUDA card
(this rank's) unless the caller passes ``device="cpu"``; there is no quiet
fallback.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from ..models import save_serialized, serialize
from ..ops.dropout import seed_generators
from ..parallel import dp_shard_info, local_mesh, local_shard_info, make_mesh, sequence, shard_batch
from ..utils.console import print_only
from .checkpoints import CheckpointManager
from .loggers import BaseLogger, make_default_logger
from .optimizers import get_learning_rate, set_learning_rate
from .schedulers import NoamLR

TEST_EVERY = 10  # epochs between runs of the test loader


def bf16_forward(model, fused: bool = False, apply_fn=None, **kernel_apply):
    """The JAX Trainer's mixed-precision forward: est = forward(mix) in f32
    from bf16 casts of ``model``'s f32 parameters and of the mix (the
    gradients reach the f32 parameters through the casts).  With ``fused``
    (a ConvTasNet) ``make_kernel_train_apply`` runs on the casts (the TCN
    chain through its forward and backward kernels; ``kernel_apply`` is
    passed to it), with ``apply_fn`` (``apply_fn(params, mix)``, e.g. one of
    ConvTasNet's other train forms) that function, otherwise
    ``torch.func.functional_call``."""
    bf = torch.bfloat16
    params = dict(model.named_parameters())
    if fused:
        from ..models.convtasnet import make_kernel_train_apply

        apply_fn = make_kernel_train_apply(model, **kernel_apply)

    def forward(mix):
        cast = {k: p.to(bf) if p.dtype == torch.float32 else p for k, p in params.items()}
        if apply_fn is not None:
            return apply_fn(cast, mix.to(bf)).float()
        return torch.func.functional_call(model, cast, (mix.to(bf),)).float()

    return forward


def _sum_over_sp_mean_over_dp(dp: int):
    """DDP's gradient reduction under a (dp, sp) mesh: each rank's partial
    gradients summed over every rank and divided by ``dp`` (DDP's own
    divides by the world size, which would shrink them by sp)."""

    def hook(group, bucket):
        fut = dist.all_reduce(bucket.buffer().div_(dp), group=group, async_op=True).get_future()
        return fut.then(lambda f: f.value()[0])

    return hook


class TrainForward(nn.Module):
    """The whole train forward as one module: ``self(mix, step)`` seeds the
    dropout generators from (seed, ``step``, ``rank``: the dp coordinate
    under sp), runs ``forward_fn`` (the
    module, or ``bf16_forward``'s casts and fused path) and returns the f32
    estimate, inside one checkpointed region under ``remat`` so that the
    recomputation draws the same masks; under ``mesh`` (with an ``sp``
    axis) the forward runs sequence parallel and each rank keeps 1 / sp of
    the estimate's gradient.  ``DistributedDataParallel`` arms
    its gradient reduction only inside its own forward, so wrapping this
    module (and not the model, which ``bf16_forward`` calls around DDP)
    lets it see every path."""

    def __init__(self, model: nn.Module, forward, seed: int, rank: int, remat: bool, mesh=None):
        super().__init__()
        self.model = model
        self.forward_fn = forward
        self.seed, self.rank, self.remat = seed, rank, remat
        self.mesh = mesh  # a (dp, sp) mesh: the forward shares each sample across the sp group

    def _run(self, mix, step: int):
        seed_generators(self.model, self.seed, step, self.rank)
        with sequence.use_mesh(self.mesh):  # inside the checkpointed region: a recomputation shards too
            return sequence.share_replicated(self.forward_fn(mix))

    def forward(self, mix, step: int):
        if self.remat:
            return checkpoint(self._run, mix, step, use_reentrant=False)
        return self._run(mix, step)


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
                 logger: Optional[BaseLogger] = None, fused_forward: bool = False, remat: bool = False,
                 sp: int = 1, device="cuda"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be float32 or bfloat16, got {precision!r}")
        self.exp_dir = exp_dir
        self.epochs = epochs
        self.precision = precision
        self.seed = seed  # the dropout masks' seed (the JAX Trainer's default)
        # opt-in: bf16 training through the TCN chain's kernels
        self.fused_forward = fused_forward
        self.remat = remat  # recompute the train forward's activations in the backward
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device=\"cpu\" to train on the CPU")
        self.device = local_mesh(device)
        self.sp = sp  # ranks that share each sample (sequence parallel); the data go by the dp coordinate
        self.rank = local_shard_info()[0]
        self.dp_rank = dp_shard_info(sp)[0]
        self.is_main = self.rank == 0  # owns the checkpoints, the logs and the epoch lines
        es = dict(early_stop or {})
        es.setdefault("monitor", "val_loss/dataloader_idx_0")
        self.early_stop = EarlyStopping(**es)
        ck = dict(checkpoint or {})
        ck.setdefault("monitor", "val_loss/dataloader_idx_0")
        self.ckpt = CheckpointManager(os.path.join(exp_dir, ""), **{
            k: v for k, v in ck.items()
            if k in ("monitor", "mode", "save_top_k", "save_last", "filename")})
        self.logger = None
        if self.is_main:
            self.logger = logger or make_default_logger(logger_dir or os.path.join(exp_dir, "logs"))

    def _fused(self, model) -> bool:
        """Whether ``model`` trains on the fused path: bf16 with
        ``fused_forward`` on a ConvTasNet (every other model ignores it)."""
        from ..models.convtasnet import ConvTasNet

        return self.precision == "bfloat16" and self.fused_forward and isinstance(model, ConvTasNet)

    def _make_forward(self, model):
        """est = forward(mix) in f32, by ``precision`` and ``fused_forward``."""
        if self.precision == "float32":
            return model
        return bf16_forward(model, self._fused(model))

    def train_module(self, model) -> nn.Module:
        """The train forward of ``model`` as one module, ``m(mix, step) ->
        est``; under ``DistributedDataParallel`` over the ``dp`` mesh when a
        process group is up (which broadcasts rank 0's parameters and
        buffers).  DDP takes the graph as static: every model here reaches
        the same parameters at every step, though not always all of them
        (TDANet's deepest fusion is never used, as in the reference), which
        DDP then learns at the first step."""
        fused = self._fused(model)
        if self.remat and fused:
            print_only("remat: nothing to recompute on the fused ConvTasNet path (the JAX Trainer's fused "
                       "path bypasses its checkpoint too); the TCN chain's kernels keep their own state")
        mesh = None
        if self.sp > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"Trainer: sp={self.sp} needs a process group (parallel.init_distributed)")
            mesh = make_mesh(self.device, ("dp", "sp"), (dist.get_world_size() // self.sp, self.sp))
        module = TrainForward(model, self._make_forward(model), self.seed, self.dp_rank,
                              self.remat and not fused, mesh)
        if not dist.is_initialized():
            return module
        device_ids = [self.device.index] if self.device.type == "cuda" else None
        if mesh is None:
            return DistributedDataParallel(module, device_ids=device_ids,
                                           process_group=make_mesh(self.device).get_group("dp"), static_graph=True)
        ddp = DistributedDataParallel(module, device_ids=device_ids, static_graph=True)  # over every rank
        ddp.register_comm_hook(None, _sum_over_sp_mean_over_dp(dist.get_world_size() // self.sp))
        return ddp

    def _batch(self, np_batch):
        mix, sources, _keys = np_batch
        return shard_batch((mix, sources), self.device)

    def _mean_over_ranks(self, total, count: int) -> float:
        """Σ total / Σ count over every rank (one all-reduce of both; this
        rank's alone without a process group); NaN when no rank saw an
        item."""
        both = torch.tensor([0.0 if total is None else float(total), float(count)], dtype=torch.float64,
                            device=self.device)
        if dist.is_initialized():
            dist.all_reduce(both)
        return float(both[0] / both[1]) if both[1] > 0 else float("nan")

    def _eval_epoch(self, forward, loss_func, loader) -> float:
        """Batch-size-weighted mean loss over a loader, each rank on its own
        shard with no collective inside the loop, then reduced exactly
        across the ranks however unequal their shards are."""
        tot, wsum = None, 0
        with torch.no_grad():
            for b in loader:
                mix, sources = self._batch(b)
                loss = loss_func(forward(mix), sources) * len(mix)
                tot = loss if tot is None else tot + loss
                wsum += len(mix)
        return self._mean_over_ranks(tot, wsum)

    def fit(self, system):
        """Train ``system`` (resuming from last.ckpt when there is one);
        returns the trained module."""
        model = system.audio_model.to(self.device)
        opt = system.optimizer
        scheduler = system.scheduler
        train_loss_fn, val_loss_fn = system.loss_func["train"], system.loss_func["val"]

        start_epoch, global_step = 0, 0
        resume = self.ckpt.maybe_resume()
        if resume is not None:
            model.load_state_dict({k: torch.from_numpy(v) for k, v in resume["model"].items()})
            opt.load_state_dict(resume["optimizer"])
            start_epoch = resume["epoch"] + 1
            global_step = resume.get("global_step", start_epoch * max(1, len(system.train_loader)))
            if scheduler is not None and resume.get("scheduler"):
                scheduler.load_state_dict(resume["scheduler"])
            if resume.get("early_stop"):
                self.early_stop.load_state_dict(resume["early_stop"])
        elif getattr(system, "warm_start", None) is not None:
            pretrained, merge_fn = system.warm_start
            merge_fn(model, pretrained)
        train_module = self.train_module(model)
        forward = getattr(train_module, "module", train_module).forward_fn  # evaluation: outside DDP, no remat
        if self.is_main:
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
                loss = train_loss_fn(train_module(mix, global_step), sources)
                loss.backward()
                opt.step()
                global_step += 1
                if isinstance(scheduler, NoamLR):
                    current_lr = scheduler.step_batch()
                    set_learning_rate(opt, current_lr)
                loss = loss.detach() * len(mix)
                loss_sum = loss if loss_sum is None else loss_sum + loss
                nseen += len(mix)
            train_loss = self._mean_over_ranks(loss_sum, nseen)

            model.eval()
            val_loss = self._eval_epoch(forward, val_loss_fn, system.val_loader)
            test_loss = None
            if system.test_loader is not None and epoch % TEST_EVERY == 0:
                test_loss = self._eval_epoch(forward, val_loss_fn, system.test_loader)

            if scheduler is not None and not isinstance(scheduler, NoamLR):
                current_lr = scheduler.step(val_loss)
                set_learning_rate(opt, current_lr)
            if self.is_main:
                self.logger.log_scalar("train_loss", train_loss, epoch)
                self.logger.log_scalar("val_loss", val_loss, epoch)
                self.logger.log_scalar("val_pit_sisnr", -val_loss, epoch)
                if test_loss is not None:
                    self.logger.log_scalar("test_loss", test_loss, epoch)
                    self.logger.log_scalar("test_pit_sisnr", -test_loss, epoch)
                self.logger.log_scalar("learning_rate", get_learning_rate(opt), epoch)
            print_only(f"epoch {epoch}: train_loss={train_loss:.4f} val_loss={val_loss:.4f}"
                       + (f" test_loss={test_loss:.4f}" if test_loss is not None else "")
                       + (f" lr={current_lr:.2e}" if current_lr is not None else "")
                       + f" ({time.time() - t0:.1f}s)")

            if self.is_main:
                self.ckpt.save({
                    "model": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
                    "optimizer": opt.state_dict(),
                    "scheduler": scheduler.state_dict() if scheduler else None,
                    "early_stop": self.early_stop.state_dict(),
                    "global_step": global_step,
                    "config": getattr(system, "config", None),
                }, epoch, val_loss)
            if self.early_stop.step(val_loss):  # the same decision on every rank: val_loss is reduced
                break

        if self.is_main:
            # the portable best model (reference audio_train.py:139-148)
            self.ckpt.write_best_k()
            if self.ckpt.best_k:
                best = self.ckpt.load()
                save_serialized(serialize(model, state_dict=best["model"]),
                                os.path.join(self.exp_dir, "best_model.pth"))
            self.logger.close()
        if dist.is_initialized():
            dist.barrier()  # every rank returns once rank 0's artifacts are written
        return model
