"""Whether the port's dispatch takes the faster path at each in-model shape
(counterpart of ``scripts/measure_gates.py``), on one card.

    python -m audio_only_speech_separation_tpu_torch.measure_gates

Three dispatch rules are measured:

- attention (``ops/attention.py``): inside ``attention_kernel_ok`` K4, else
  the plain einsum form.  K4 against its plain version
  (``attention_bdt_reference``, the plain form's attention) on [BH, dh, T]
  at Sepformer's, Sandglasset's and DPTNet's shapes;
- LSTM (``ops/rnn.py``): inside ``lstm_kernel_ok``, ``kernel_choice``'s
  K5 with its library input product (``recurrence_form``) or K6, and the
  plain scan outside.  The three paths, bf16, at every LSTM call of a
  served family at its ``bench_all`` batch and at B=1: TasNet-DPRNN's rows
  and columns, the grouped TasNet's cores and context RNNs, DPRNNTasNet's
  rows and columns, Sandglasset's intra pass, BSRNN's band and band-comm
  RNNs, and ``layers.DPRNNBlock``'s one-direction column pass.

Each time is the median of 5 CUDA-event readings around back-to-back
calls.  SDPA's and bf16 ``nn.LSTM``'s times are printed beside the rows for
information; no verdict reads them.  A rule misroutes at a shape where
the path it takes is more than 10 % slower than the fastest; the command
exits with 1 if any does.  It needs a card.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np
import torch

from .ops.kernels.attention import attention_bdt_reference, attention_kernel_ok, fused_attention_bdt
from .ops.kernels.lstm import lstm_kernel_ok, resident_bilstm, resident_bilstm_reference
from .ops.rnn import kernel_choice, recurrence_form

# [BH, dh, T] of K4 in the models (PERF.md section 6): Sepformer B=2 x 2 s x 16 kHz intra and inter,
# Sandglasset B=8 x 2 s x 8 kHz blocks 0/5 and 1/4, DPTNet (wsj0) B=8 x 2 s x 8 kHz rows
ATTENTION = {"sepformer intra": (544, 32, 250), "sepformer inter": (4000, 32, 34),
             "sandglasset 0/5": (16000, 16, 131), "sandglasset 1/4": (3968, 16, 131),
             "dptnet rows": (1344, 16, 100)}
# (T, sequences, Din, H, D) of the LSTMs at B=1 and at bench_all's batch (8; PERF.md section 6): TasNet-DPRNN
# (wsj0, 2 s x 8 kHz: K = 100, S = 42), the grouped TasNet (group size 2: cores' rows and columns, context
# GC_RNNs), DPRNNTasNet (2 s: K = 32, S = 128), Sandglasset (2 s: K = 250, S = 131), BSRNN (4 s: 501 frames,
# 8 bands), layers.DPRNNBlock with one-direction columns at TasNet-DPRNN's chunks
LSTM = {"dprnn rows B=1": (100, 42, 64, 128, 2), "dprnn columns B=1": (42, 100, 64, 128, 2),
        "dprnn rows B=8": (100, 336, 64, 128, 2), "dprnn columns B=8": (42, 800, 64, 128, 2),
        "grouped rows B=1": (100, 12, 32, 64, 2), "grouped columns B=1": (6, 200, 32, 64, 2),
        "grouped context B=1": (24, 336, 32, 64, 2), "grouped rows B=8": (100, 96, 32, 64, 2),
        "grouped columns B=8": (6, 1600, 32, 64, 2), "grouped context B=8": (24, 2688, 32, 64, 2),
        "dprnn-tasnet rows B=1": (32, 128, 128, 256, 2), "dprnn-tasnet columns B=1": (128, 32, 128, 256, 2),
        "dprnn-tasnet rows B=8": (32, 1024, 128, 256, 2), "dprnn-tasnet columns B=8": (128, 256, 128, 256, 2),
        "sandglasset intra B=1": (250, 131, 128, 128, 2), "sandglasset intra B=8": (250, 1048, 128, 128, 2),
        "bsrnn band B=1": (501, 8, 128, 256, 2), "bsrnn band-comm B=1": (8, 501, 128, 256, 2),
        "bsrnn band B=8": (501, 64, 128, 256, 2), "bsrnn band-comm B=8": (8, 4008, 128, 256, 2),
        "DPRNNBlock columns B=1": (42, 100, 64, 128, 1), "DPRNNBlock columns B=8": (42, 800, 64, 128, 1)}
SLOWER = 1.1  # a rule misroutes where its path takes more than this times the fastest
REPS = 5


def event_ms(fn, calls: int, reps: int = REPS) -> float:
    """Median over ``reps`` of the CUDA-event ms of ``calls`` back-to-back
    calls of ``fn``, over ``calls``; after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def attention_rows(dev) -> list:
    rng = np.random.default_rng(0)
    rows = []
    for name, (BH, dh, T) in ATTENTION.items():
        q, k, v = (torch.from_numpy(rng.standard_normal((BH, dh, T)).astype(np.float32)).to(dev, torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (a.transpose(1, 2).reshape(BH // 8, 8, T, dh).contiguous() for a in (q, k, v))
        times = {"K4": event_ms(lambda: fused_attention_bdt(q, k, v), 20),
                 "plain": event_ms(lambda: attention_bdt_reference(q, k, v), 5)}
        info = {"SDPA": event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt), 20)}
        rows.append({"rule": "attention", "name": name, "shape": (BH, dh, T), "times": times, "info": info,
                     "choice": "K4" if attention_kernel_ok(dh) else "plain"})
    return rows


def lstm_rows(dev) -> list:
    rng = np.random.default_rng(1)

    def rand(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)

    rows = []
    for name, (T, B, Din, H, D) in LSTM.items():
        x, w_ih, w_hh = rand((B, T, Din), 0.5), rand((D, Din, 4 * H), 0.08), rand((D, H, 4 * H), 0.05)
        bias = rand((D, 4 * H), 0.05, torch.float32)
        with torch.no_grad():
            times = {"K5": event_ms(lambda: recurrence_form(x, w_ih, w_hh, bias), 10),
                     "K6": event_ms(lambda: resident_bilstm(x, w_ih, w_hh, bias), 10),
                     "plain": event_ms(lambda: resident_bilstm_reference(x, w_ih, w_hh, bias), 1)}
            lstm = torch.nn.LSTM(Din, H, batch_first=True, bidirectional=D == 2).to(dev, torch.bfloat16)
            info = {"nn.LSTM": event_ms(lambda: lstm(x), 5)}
        rows.append({"rule": "lstm", "name": name, "shape": (T, B, Din, H, D), "times": times, "info": info,
                     "choice": kernel_choice(T, B, Din, H, D) if lstm_kernel_ok(H) else "plain"})
    return rows


def verdicts(rows: list) -> int:
    """Marks each row with its fastest path and whether the rule's choice
    misroutes (its time above ``SLOWER`` x the fastest); returns the count
    of misroutes."""
    bad = 0
    for r in rows:
        r["best"] = min(r["times"], key=r["times"].get)
        r["misroute"] = r["times"][r["choice"]] > SLOWER * r["times"][r["best"]]
        bad += r["misroute"]
    return bad


def report(rows: list, card: str) -> str:
    lines = [f"dispatch rules against measurement (CUDA events, median of {REPS}; {card})"]
    for r in rows:
        times = ", ".join(f"{k} {v:.4f}" for k, v in r["times"].items())
        info = ", ".join(f"{k} {v:.4f}" for k, v in r["info"].items())
        flag = "  <-- MISROUTES" if r["misroute"] else ""
        lines.append(f"{r['rule']} {r['name']} {r['shape']}: {times} ms; the rule takes {r['choice']}, the fastest "
                     f"is {r['best']} ({info} ms, for information){flag}")
    return "\n".join(lines)


def measure() -> tuple:
    """Every shape measured on the card and the report printed; returns
    (the rows, the count of misroutes)."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure_gates: no CUDA device; the kernels' times need one")
    dev = torch.device("cuda")
    rows = attention_rows(dev) + lstm_rows(dev)
    bad = verdicts(rows)
    print(report(rows, torch.cuda.get_device_name(dev)), flush=True)
    print(f"{bad} misroute(s)", flush=True)
    return rows, bad


def main(argv=None) -> list:
    """``measure``; returns the rows, or raises SystemExit(1) after the
    report when a rule misroutes."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    rows, bad = measure()
    if bad:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
