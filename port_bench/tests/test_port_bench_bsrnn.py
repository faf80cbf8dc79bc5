"""The BSRNN-WSJ0 cell's yardstick on the CPU: the reference's FLOP formula
against ``FlopCounterMode``, its band partition and LSTM launch shapes
against the port's (``models/bsrnn.py::compute_band_widths``,
``ops/rnn.py::kernel_choice`` and the launches a small forward makes), K5's
and K6's work by hand (``port_bench/lstm_work.py``), and the three readers of
``metrics/`` on hand-built traces."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from audio_only_speech_separation_tpu_torch.models.bsrnn import compute_band_widths
from audio_only_speech_separation_tpu_torch.ops import kernels
from audio_only_speech_separation_tpu_torch.ops import rnn as port_rnn
from audio_only_speech_separation_tpu_torch.ops.kernels.lstm import bilstm_reference, resident_bilstm_reference
from port_bench import harness
from port_bench.bounds import least_time
from port_bench.lstm_work import recurrence_work, resident_work
from port_bench.reference import bsrnn as ref
from port_bench.tests.small import small_config
from port_bench.trace import Trace

CPU = torch.device("cpu")
PUBLISHED = harness.load_json(harness.HERE / "configs" / "bsrnn_wsj0.json")["model_args"]


@pytest.mark.parametrize("T", [4001, 8000])
def test_flop_formula_is_flopcountermodes(T):
    """The formula of one utterance, times the batch of 2, counts exactly
    the products FlopCounterMode counts in the reference's forward (no FFT,
    norm, gate or elementwise FLOPs in either)."""
    cfg, _ = small_config("bsrnn_wsj0")
    a = cfg["model_args"]
    sd = harness.make_state_dict(ref, a, 5, CPU)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref.forward(sd, torch.randn(2, T, generator=torch.Generator().manual_seed(1)) * 0.05, a)
    assert counter.get_total_flops() == 2 * ref.forward_flops(a, T)


def test_published_request_by_hand():
    """One 6.0 s request at 8 kHz: 751 frames in 8 bands of [3, 3, 8, 8, 8,
    16, 16, 67] bins; 16 residual RNNs of 8 x 751 positions each
    (1,703,936 FLOPs a position: both directions' input and recurrent
    products and the projection, N 128, H 256), the bands' 1x1s and the
    mask heads: 168.4 GFLOP."""
    assert ref.frames(PUBLISHED, 48000) == 751
    assert ref.band_widths(8000, 129) == [3, 3, 8, 8, 8, 16, 16, 67]
    rnn = 16 * 8 * 751 * (2 * 2 * 128 * 1024 + 2 * 2 * 256 * 1024 + 2 * 512 * 128)
    bws = [3, 3, 8, 8, 8, 16, 16, 67]
    mask = 751 * sum(2 * 128 * 512 + 2 * 512 * 512 + 2 * 512 * 4 * bw + 2 * 4 * bw * 8 * bw for bw in bws)
    assert ref.forward_flops(PUBLISHED, 48000) == rnn + mask + 751 * 2 * 128 * 2 * 129
    assert ref.forward_flops(PUBLISHED, 48000) == pytest.approx(168.4e9, rel=1e-3)


@pytest.mark.parametrize("sample_rate,win", [(8000, 256), (16000, 256), (16000, 512), (44100, 2048)])
def test_band_partition_is_the_ports(sample_rate, win):
    assert ref.band_widths(sample_rate, win // 2 + 1) == compute_band_widths(sample_rate, win // 2 + 1)


def test_lstm_shapes_at_the_published_widths():
    """A 6.0 s request at batch 1: per BSNet K5 on the band RNN (751 steps,
    2 directions, 8 sequences, H 256) and K6 on the band-comm RNN (8 steps,
    751 sequences, Din 128), 16 launches; the port's ``kernel_choice`` routes
    each shape the same way."""
    shapes = ref.lstm_shapes(PUBLISHED, 1, 48000)
    assert shapes == {"K5": [(751, 2, 8, 256)] * 8, "K6": [(8, 751, 128, 256, 2)] * 8}
    for T, D, B, H in shapes["K5"]:
        assert port_rnn.kernel_choice(T, B, 128, H, D) == "K5"
    for T, B, Din, H, D in shapes["K6"]:
        assert port_rnn.kernel_choice(T, B, Din, H, D) == "K6"
    assert ref.lstm_shapes(PUBLISHED, 4, 48000)["K5"] == []  # 32 sequences: K6 (the grid's rule)


@pytest.mark.parametrize("batch", [1, 2])
def test_lstm_shapes_are_the_ports_launches(monkeypatch, batch):
    """A BSRNN at the published depth (8 BSNets) and a cut width (N 16, H 32)
    on 1.25 s waves (157 frames), the card forced (``kernel_input``) and the
    kernels replaced by their plain versions that record their shapes: the
    launches are ``lstm_shapes``', in order, 8 K5 and 8 K6."""
    seen = {"K5": [], "K6": []}

    def k5(xw, w_hh):
        T, D, B, G = xw.shape
        seen["K5"].append((T, D, B, G // 4))
        return bilstm_reference(xw, w_hh)

    def k6(x, w_ih, w_hh, bias):
        B, T, Din = x.shape
        seen["K6"].append((T, B, Din, w_hh.shape[1], w_hh.shape[0]))
        return resident_bilstm_reference(x, w_ih, w_hh, bias)

    cfg, _ = small_config("bsrnn_wsj0")
    cfg = dict(cfg, model_args=dict(cfg["model_args"], num_repeat=8))
    sd = harness.make_state_dict(ref, cfg["model_args"], 3, CPU)
    model = harness.build_model(cfg, sd, "cpu").eval()
    monkeypatch.setattr(kernels, "kernel_input", lambda x: True)
    monkeypatch.setattr(port_rnn, "fused_bilstm", k5)
    monkeypatch.setattr(port_rnn, "resident_bilstm", k6)
    with torch.no_grad():
        model(torch.randn(batch, 10000, generator=torch.Generator().manual_seed(2)) * 0.05)
    want = ref.lstm_shapes(cfg["model_args"], batch, 10000)
    assert seen == want and len(want["K5"]) == len(want["K6"]) == 8


def test_k5_and_k6_work_by_hand():
    """K5 at (751, 2, 8, 256): xw 24.6 MB in, h 6.2 MB out, W_hh 1.0 MB, all
    bf16; 6.3 GFLOP; bytes bound it at 9.50 us.  K6 at (8, 751, 128, 256, 2):
    x 1.5 MB in, h 6.2 MB out, W_ih and W_hh 1.6 MB; 9.4 GFLOP; operations
    bound it at 9.55 us."""
    nbytes, flops = recurrence_work(751, 2, 8, 256)
    assert nbytes == 751 * 2 * 8 * 1024 * 2 + 751 * 2 * 8 * 256 * 2 + 2 * 256 * 1024 * 2 == 31_809_536
    assert flops == 2 * 751 * 2 * 8 * 256 * 1024
    t, bound = least_time(nbytes, flops)
    assert bound == "bytes" and t * 1e6 == pytest.approx(9.495, abs=1e-3)
    nbytes, flops = resident_work(8, 751, 128, 256, 2)
    assert nbytes == 751 * 8 * 128 * 2 + 8 * 2 * 751 * 256 * 2 + 2 * (128 + 256) * 1024 * 2 == 9_263_104
    assert flops == 2 * 8 * 2 * 751 * (128 + 256) * 1024
    t, bound = least_time(nbytes, flops)
    assert bound == "operations" and t * 1e6 == pytest.approx(9.555, abs=1e-3)


def _ctx(device_ops, requests=((48000,),) * 2):
    tr = Trace(device=[(n, i * 10_000_000, i * 10_000_000 + dur) for i, (n, dur) in enumerate(device_ops)])
    cell = SimpleNamespace(cfg={"model_args": PUBLISHED}, ref=ref)
    return SimpleNamespace(cell=cell, trace=tr, read={"bucket": 8000, "traced": {"requests": list(requests)}})


def _reader(name):
    return harness.load_reader(name).read


def test_readers_on_a_trace_with_k5_and_k6():
    """Two traced requests, 8 K5 launches of 3 ms and 8 K6 of 0.1 ms each:
    16.0 launches a request; each roofline the least time of the 16
    launches of its kernel over their device time."""
    ops = ([("lstm_recurrence_kernel", 3_000_000)] * 8 + [("lstm_resident_kernel", 100_000)] * 8
           + [("gemm", 50_000)] * 20) * 2
    ctx = _ctx(ops)
    assert _reader("serve.lstm_launches")(ctx) == 16.0
    k5 = least_time(*recurrence_work(751, 2, 8, 256))[0]
    k6 = least_time(*resident_work(8, 751, 128, 256, 2))[0]
    assert _reader("k5_roofline")(ctx) == pytest.approx(100 * 16 * k5 / (16 * 3e-3))
    assert _reader("k6_roofline")(ctx) == pytest.approx(100 * 16 * k6 / (16 * 1e-4))


def test_readers_find_nothing_without_the_kernels():
    """A trace with device work but no LSTM kernel (the plain path): no
    roofline, 0 launches; a trace with no device operation (the CPU): none
    of the three."""
    ctx = _ctx([("gemm", 50_000)] * 10)
    assert _reader("k5_roofline")(ctx) is None and _reader("k6_roofline")(ctx) is None
    assert _reader("serve.lstm_launches")(ctx) == 0.0
    empty = _ctx([])
    assert all(_reader(m)(empty) is None for m in ("k5_roofline", "k6_roofline", "serve.lstm_launches"))

