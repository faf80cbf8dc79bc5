"""The yardstick's bounds against ``chip_smoke.py``'s, from which they were
copied, at the shapes of PERF.md's table of kernels: K1 at the bench shape
(8 utterances of 2 s, 8003 frames), K2 and K3 at the train shape (12 of
2 s)."""

from __future__ import annotations

import pytest

import chip_smoke
from port_bench import bounds

FRAMES = chip_smoke.train_frames(2 * 16000)


def test_frames_of_two_seconds():
    assert FRAMES == 8003


@pytest.mark.parametrize("work,ours,ms", [
    (lambda m: m.separator_work(8, FRAMES), bounds.separator_work(8, FRAMES), 0.4502),
    (lambda m: m.chain_work(12, FRAMES), bounds.chain_work(12, FRAMES), 0.6181),
    (lambda m: m.chain_work(12, FRAMES, products=5), bounds.chain_work(12, FRAMES, products=5), 1.5345),
])
def test_bounds_match_chip_smoke(work, ours, ms):
    assert ours == work(chip_smoke)
    t, by = bounds.least_time(*ours)
    t_ms, by_ms = chip_smoke.least_time(*work(chip_smoke))
    assert by == by_ms == "operations" and t * 1e3 == pytest.approx(t_ms, rel=1e-12)
    assert round(t * 1e3, 4) == ms


def test_backward_counts_four_products():
    """The yardstick's K3 bound: the 4 products the gradients need, not the
    5 that K3 runs."""
    four, five = bounds.chain_work(12, FRAMES, products=4), bounds.chain_work(12, FRAMES, products=5)
    assert four[0] == five[0] and four[1] < five[1]
    assert bounds.least_time(*four)[0] * 1e3 == pytest.approx(1.5345 * (4 * 2 * 128 * 512 + 6 * 512)
                                                             / (5 * 2 * 128 * 512 + 6 * 512), rel=1e-4)
