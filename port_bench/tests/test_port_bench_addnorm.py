"""K8's yardstick: the sites of Sepformer's pre-norm stacks and the bytes
each needs (``port_bench/addnorm_work.py``), and the two per-layer metrics
that read K8 in a trace, on a trace with K8 and on one without (a program
that lacks it)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench import harness
from port_bench.addnorm_work import addnorm_shapes, addnorm_work
from port_bench.bounds import least_time
from port_bench.trace import Trace

CFG = harness.load_json(harness.HERE / "configs" / "sepformer_base.json")["model_args"]


def _bytes(batch, T, cfg=CFG):
    return sum(addnorm_work(*site)[0] for site in addnorm_shapes(cfg, batch, T))


def test_cell_request_is_68_sites_of_9_19_gb():
    """The cell's 8 x 2 s x 16 kHz request: 4 stacks x 17 sites over 68,000
    rows of 256, 9.19 GB (each stack 66 passes over [68000, 256] in bf16
    and its position table), a least time of 2.74 ms at 3.35 TB/s."""
    sites = addnorm_shapes(CFG, 8, 32000)
    assert len(sites) == 68 and {s[:2] for s in sites} == {(68000, 256)}
    assert sum(not s[3] for s in sites) == 4 and sorted({s[2] for s in sites}) == [34, 250, 68000]
    assert _bytes(8, 32000) == pytest.approx(9.19e9, rel=5e-3)
    assert _bytes(8, 32000) == 4 * 66 * 68000 * 256 * 2 + 2 * (250 + 34) * 256 * 2
    least = sum(least_time(*addnorm_work(*s))[0] for s in sites)
    assert least * 1e3 == pytest.approx(2.74, abs=0.005)


@pytest.mark.parametrize("batch,T", [(2, 48000), (3, 20000), (1, 32000)])
def test_bytes_follow_the_formula(batch, T):
    """At any batch and length: a stack of L layers over R rows, positions of
    length n, reads x at its 1 + 2L sites, its addends (the table once) and
    writes every LayerNorm and every sum but the last: R (4 (1 + 2L) - 2) + n
    elements of 2 bytes and width d."""
    L = (T - 16) // 8 + 1
    S = 2 * (L + 250 - (125 + L % 250) % 250 + 125) // 250
    R, d = batch * S * 250, 256
    per_block = (R * (4 * 17 - 2) + 250) + (R * (4 * 17 - 2) + S)
    assert _bytes(batch, T) == 2 * d * 2 * per_block


def test_post_norm_and_position_free_stacks():
    """A post-norm stack has no K8 site; a stack without positions starts at
    its first residual site (2L sites)."""
    post = dict(CFG, intra_norm_before=False)
    assert len(addnorm_shapes(post, 8, 32000)) == 2 * 17
    bare = dict(CFG, inter_use_positional=False)
    assert len(addnorm_shapes(bare, 8, 32000)) == 2 * (17 + 16)


def _ctx(device_ops, requests=((32000,) * 8,) * 2):
    tr = Trace(device=[(n, i * 10_000, i * 10_000 + dur) for i, (n, dur) in enumerate(device_ops)])
    cell = SimpleNamespace(cfg={"model_args": CFG})
    return SimpleNamespace(cell=cell, trace=tr, read={"bucket": 16000, "traced": {"requests": list(requests)}})


def _reader(name):
    return harness.load_reader(name).read


def test_readers_on_a_trace_with_k8():
    """Two traced requests, 68 K8 launches each, each site 50 us on the
    device: 68.0 launches a request, and the least time over 6.8 ms."""
    ctx = _ctx([("add_layer_norm_kernel", 50_000)] * 136 + [("attention_kernel", 40_000)] * 64)
    assert _reader("serve.addnorm_launches")(ctx) == 68.0
    least = sum(least_time(*addnorm_work(*s))[0] for s in addnorm_shapes(CFG, 8, 32000))
    assert _reader("addnorm_roofline")(ctx) == pytest.approx(100 * 2 * least / (136 * 50e-6))


def test_readers_find_nothing_without_k8():
    """A trace of a program without K8 (torch's LayerNorm and adds): both
    readers give None, so the result line leaves the metrics out."""
    ctx = _ctx([("vectorized_layer_norm_kernel", 90_000)] * 68 + [("attention_kernel", 40_000)] * 32)
    assert _reader("serve.addnorm_launches")(ctx) is None
    assert _reader("addnorm_roofline")(ctx) is None
    assert _reader("addnorm_roofline")(SimpleNamespace(trace=None)) is None
