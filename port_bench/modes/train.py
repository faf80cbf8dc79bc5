"""Training: the port's ``Trainer`` step body, as ``Trainer.fit`` runs it:
``Trainer.train_module(model)(mix, step)``, the PIT loss over
``pairwise_neg_snr``, ``backward``, and the clipped optimizer of
``train.make_optimizer``.

Set-up makes the weights and a pool of batches on the device from the
seed, builds the model, the train module and the optimizer once, and
drives that same step through its first ``checked_steps`` steps, each on
its own batch of the pool: those steps warm every shape up, and their
loss, the first gradient as the optimizer holds it (Adam's first moment
after one step, over 1 - beta1) and each parameter's change after them are
kept.  The window goes on stepping through the pool.  After it the
reference trains from the same weights on the same batches, and the two
are compared leaf by leaf.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``segment_s``,
``gain_db`` (each source's level, uniform in +- that), ``pool`` batches, ``checked_steps``, ``trace_seconds`` traced at the end
of a ``--trace 1`` window.
"""

from __future__ import annotations

import statistics
import tempfile
import time

import torch

from .. import harness, trace as tracing
from . import Run

BETA1 = 0.9  # Adam's first-moment decay: torch's default, and the configuration's


class Step:
    """The step object: model, train module, loss and optimizer, built once."""

    def __init__(self, cell, sd, seed: int, device, exp_dir: str):
        from audio_only_speech_separation_tpu_torch.losses import PITLossWrapper, pairwise_neg_snr
        from audio_only_speech_separation_tpu_torch.train import Trainer, make_optimizer
        from audio_only_speech_separation_tpu_torch.train.loggers import BaseLogger

        cfg, tcfg = cell.cfg, cell.cfg["train"]
        self.model = harness.build_model(cfg, sd, device)
        trainer = Trainer(exp_dir, precision=cfg["precision"], seed=seed % 2**31, logger=BaseLogger(),
                          fused_forward=tcfg.get("fused_forward", False), device=device)
        self.module = trainer.train_module(self.model)
        self.loss_fn = PITLossWrapper(pairwise_neg_snr, pit_from="pw_mtx",
                                      threshold_byloss=tcfg["threshold_byloss"])
        self.opt = make_optimizer(self.model.parameters(), tcfg["optimizer"], lr=tcfg["lr"],
                                  grad_clip=tcfg["grad_clip"])
        self.backward_events = []

    def __call__(self, mix, src, step: int, on: bool = False, time_backward: bool = False):
        self.model.train()
        with tracing.span(on, "zero_grad"):
            self.opt.zero_grad()
        with tracing.span(on, "forward"):
            est = self.module(mix, step)
        with tracing.span(on, "loss"):
            loss = self.loss_fn(est, src)
        with tracing.span(on, "backward"):
            if time_backward:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                loss.backward()
                b.record()
                self.backward_events.append((a, b))
            else:
                loss.backward()
        with tracing.span(on, "optimizer"):
            self.opt.step()
        return loss.detach()

    def first_moment_norms(self):
        """Each leaf's first gradient as Adam holds it after one step: its
        first moment over 1 - beta1 (nought where the step kept no state)."""
        state = self.opt.opt.state
        return {n: float(torch.linalg.vector_norm(state[p]["exp_avg"].double()) / (1 - BETA1))
                if "exp_avg" in state.get(p, {}) else 0.0 for n, p in self.model.named_parameters()}

    def change_norms(self, sd):
        return {n: float(torch.linalg.vector_norm((p.detach() - sd[n]).double()))
                for n, p in self.model.named_parameters()}


def make_pool(cell, seed: int, device):
    """``pool`` batches (mix [B, T], sources [B, n, T]) on the device."""
    tr, cfg = cell.traffic, cell.cfg
    B, T = tr["batch"], int(round(tr["segment_s"] * cfg["sample_rate"]))
    src = harness.sources(tr["pool"] * B, cfg["n_src"], T, seed, device, tr["gain_db"])
    src = src.view(tr["pool"], B, cfg["n_src"], T)
    return [(s.sum(dim=1), s) for s in src.unbind(0)]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    tr = cell.traffic
    phases = [("imports", time.perf_counter() - t_start)]
    sd = harness.make_state_dict(cell.ref, cell.cfg["model_args"], seed, device)
    pool = make_pool(cell, seed, device)
    phases.append(("weights and batches", time.perf_counter() - t_start))
    n_check = tr["checked_steps"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory(prefix="port_bench_") as exp_dir:
        step = Step(cell, sd, seed, device, exp_dir)
        phases.append(("step object", time.perf_counter() - t_start))
        losses, first, change = [], None, None
        for k in range(n_check):
            losses.append(step(*pool[k % len(pool)], k))
            if k == 0:
                sync()
                phases.append(("first step", time.perf_counter() - t_start))
                first = step.first_moment_norms()
        change = step.change_norms(sd)
        sync()
        phases.append(("checked steps", time.perf_counter() - t_start))

        untraced = {"steps": 0, "seconds": 0.0}
        traced = {"steps": 0}
        holder = None
        plain_until = seconds - (tr["trace_seconds"] if trace else 0.0)
        setup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        k = n_check
        while time.perf_counter() - t0 < plain_until:
            step(*pool[k % len(pool)], k, time_backward=trace and device.type == "cuda")
            k += 1
        sync()
        untraced["seconds"] = time.perf_counter() - t0
        untraced["steps"] = k - n_check
        if trace:
            with tracing.profiled() as holder:  # timed from its own start: the profiler takes a while to start
                with torch.profiler.record_function(tracing.WINDOW):
                    t2 = time.perf_counter()
                    while True:
                        step(*pool[k % len(pool)], k, on=True)
                        k += 1
                        traced["steps"] += 1
                        if time.perf_counter() - t2 >= tr["trace_seconds"]:
                            break
                    sync()
        elapsed = time.perf_counter() - t0
        steps = k - n_check
        device_info = harness.device_info(cell.chips) if device.type == "cuda" else {}
        backward_ms = [a.elapsed_time(b) for a, b in step.backward_events]
        prog_losses = [float(x) for x in losses]
        del step

    if device.type == "cuda":
        torch.cuda.empty_cache()
    audio = tr["batch"] * tr["segment_s"]
    e2e = {"setup_s": setup_s, "train_audio_s_per_s": audio * steps / elapsed}
    checks, info = compare(cell, sd, pool[:n_check], prog_losses, first, change)
    failed = sum(1 for x in prog_losses if x != x)
    read = {"untraced": untraced, "traced": traced, "backward_ms": backward_ms, "setup_phases": phases,
            "comparison": info}
    return Run(attempted=steps + n_check, failed=failed, end_to_end=e2e, checks=checks, read=read,
               trace=holder.trace if holder else None, device=device_info)


def reference_readings(cell, sd, batches, q=None):
    """(losses, first-gradient norms, change norms) of the reference's
    steps on ``batches`` (products through ``q`` for the control)."""
    from ..reference.common import exact_f32, train_steps

    exact_f32()
    tcfg = cell.cfg["train"]
    forward = lambda params, mix, qq: cell.ref.forward(params, mix, cell.cfg["model_args"], qq)  # noqa: E731
    losses, first, after = train_steps(forward, sd, batches, lr=tcfg["lr"], grad_clip=tcfg["grad_clip"],
                                       threshold_byloss=tcfg["threshold_byloss"], q=q)
    return losses, harness.leaf_norms(first), harness.leaf_norms({k: after[k] - sd[k] for k in sd})


def moved_leaves(first_ref: dict):
    """The leaves the change is compared on: those whose first gradient in
    the reference is at least a thousandth of the median leaf's (a leaf
    under it moves under Adam by rounding alone)."""
    median = statistics.median(first_ref.values())
    return [k for k, v in first_ref.items() if v >= 1e-3 * median]


def compare(cell, sd, batches, losses, first, change, reference=None):
    """(the numbers compared, what else the comparison read).

    Each leaf's gap is the gap of its norm against the larger of its and
    the median leaf's reference norm (``harness.leaf_gaps``), of the first
    gradient over every leaf and of the change after the checked steps
    over the leaves the reference moves (``moved_leaves``).  Compared: the
    first step's loss gap (dB), and of each the median leaf's gap and the
    worst gap of a leaf of more than one element: the median holds the
    whole, the worst multi-element leaf any one layer (the plain encoder,
    bottleneck, mask head and decoder as much as a block of the TCN).
    Read and printed, not compared: the worst leaf over every leaf, a
    one-element PReLU slope whose gap swings from seed to seed, and the
    later steps' loss gaps (under Adam every element moves by about the
    learning rate whatever its gradient, so elements whose gradient is
    near nought move apart in the two precisions and the later losses
    spread with them; PERF.md)."""
    ref_losses, ref_first, ref_change = reference or reference_readings(cell, sd, batches)
    grad = harness.leaf_gaps(first, ref_first)
    moved = harness.leaf_gaps(change, ref_change, moved_leaves(ref_first))
    info = {"loss_gaps_db": [abs(a - b) for a, b in zip(losses, ref_losses)]}
    for key, gaps in (("grad", grad), ("change", moved)):
        worst = max(gaps, key=gaps.get)
        info[f"{key}_worst"], info[f"{key}_worst_leaf"] = gaps[worst], worst
        multi = max((k for k in gaps if sd[k].numel() > 1), key=gaps.get)
        info[f"{key}_worst_multi"], info[f"{key}_worst_multi_leaf"] = gaps[multi], multi
        info[f"{key}_median"] = statistics.median(gaps.values())
        info[f"{key}_p90"] = harness.percentile(list(gaps.values()), 90)
        info[f"{key}_top5"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    checks = {"loss1_gap_db": info["loss_gaps_db"][0], "grad_gap_median_leaf": info["grad_median"],
              "change_gap_median_leaf": info["change_median"],
              "grad_gap_worst_multi_leaf": info["grad_worst_multi"],
              "change_gap_worst_multi_leaf": info["change_worst_multi"]}
    return checks, info
