"""A run with the timed path broken underneath comes out as not correct:
the harness's look for a card skipped (the CPU, small widths), the rest of
the run driven as the benchmark drives it, one fault each of those the
cells can have (one card: no exchange between cards to leave out)."""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from audio_only_speech_separation_tpu_torch import serve as port_serve
from audio_only_speech_separation_tpu_torch.losses import pit as port_pit
from audio_only_speech_separation_tpu_torch.train import optimizers as port_optimizers
from port_bench import calibrate, harness, run as bench_run
from port_bench.modes import serve, train
from port_bench.tests.small import small_cell

CPU = torch.device("cpu")
SEED = 2**31 + 977
BENCH = harness.load_json(harness.CHECKOUT / "BENCHMARK.json")


@contextlib.contextmanager
def patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def correct(name) -> bool:
    cell = small_cell(name)
    mode = serve if cell.traffic["mode"] == "serve" else train
    run = mode.run(cell, SEED, 0.4, False, CPU, time.perf_counter())
    return bench_run.result_line(cell, run, False, BENCH)["correct"]


def answer_altered(forward):
    """The first utterance's estimate altered where the forward produces it."""
    def broken(self, mix):
        out = forward(self, mix).clone()
        out[0] = out[0] + 0.1 * out[0].std() * torch.randn_like(out[0])
        return out
    return broken


def half_batch_served(forward):
    """The forward runs on the first half of the batch; the rest come back
    as zeros."""
    def broken(self, mix):
        h = max(1, mix.shape[0] // 2)
        out = forward(self, mix[:h])
        return torch.cat([out, out.new_zeros((mix.shape[0] - h,) + out.shape[1:])])
    return broken


def half_batch_loss(call):
    """The loss is the mean over the first half of the batch only."""
    def broken(self, ests, targets, *a, **kw):
        h = max(1, targets.shape[0] // 2)
        return call(self, ests[:h], targets[:h], *a, **kw)
    return broken


def state_unchanged(step):
    """The optimizer's step returns with every parameter and state as it
    found them."""
    def broken(self):
        return None
    return broken


def test_sound_runs_are_correct():
    assert correct("convtasnet_lrs3.serve_b8_2s") and correct("convtasnet_lrs3.train_b12_2s")


def test_answer_altered():
    with patched(port_serve.Server, "forward", answer_altered):
        assert not correct("convtasnet_lrs3.serve_b8_2s")


def test_half_of_the_batch_served():
    with patched(port_serve.Server, "forward", half_batch_served):
        assert not correct("convtasnet_lrs3.serve_b8_2s")


def test_half_of_the_batch_in_the_loss():
    with patched(port_pit.PITLossWrapper, "__call__", half_batch_loss):
        assert not correct("convtasnet_lrs3.train_b12_2s")


def test_a_plain_layers_gradient_lost():
    """The decoder's filters, the model's last leaf and a plain layer
    outside the TCN's kernels, get no gradient: the median leaf does not
    see it, the worst leaf of more than one element does."""
    with calibrate.last_leaf_grad_lost():
        assert not correct("convtasnet_lrs3.train_b12_2s")


def test_state_unchanged():
    with patched(port_optimizers.Optimizer, "step", state_unchanged):
        assert not correct("convtasnet_lrs3.train_b12_2s")
