"""Whether the port's dispatch takes the faster path at each in-model shape
(counterpart of ``scripts/measure_gates.py``), on one card.

    python -m audio_only_speech_separation_tpu_torch.measure_gates

Three dispatch rules are measured:

- attention (``ops/attention.py``): inside ``attention_kernel_ok`` K4, else
  the plain einsum form.  K4 against its plain version
  (``attention_bdt_reference``, the plain form's attention) on [BH, dh, T]
  at Sepformer's, Sandglasset's and DPTNet's shapes;
- LSTM (``ops/rnn.py``): inside ``lstm_kernel_ok``, ``kernel_choice``'s
  K6 above 128 sequences, else K5 with its library input product
  (``recurrence_form``), and the plain scan outside.  The three paths at
  BSRNN's band RNN, DPRNN's rows and columns at B=8 and B=1 and
  Sandglasset's intra pass, bidirectional, bf16.

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
# (T, sequences, Din, H) of the bidirectional LSTMs: BSRNN's band RNN (B=1 x 4 s x 8 kHz), TasNet-DPRNN's
# (wsj0) rows and columns at B=8 and B=1 x 2 s x 8 kHz (K = 100, S = 42), Sandglasset's intra pass (B=8)
LSTM = {"bsrnn band": (501, 8, 128, 256), "dprnn rows B=8": (100, 336, 64, 128),
        "dprnn columns B=8": (42, 800, 64, 128), "dprnn rows B=1": (100, 42, 64, 128),
        "dprnn columns B=1": (42, 100, 64, 128), "sandglasset intra": (250, 1048, 128, 128)}
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
    for name, (T, B, Din, H) in LSTM.items():
        x, w_ih, w_hh = rand((B, T, Din), 0.5), rand((2, Din, 4 * H), 0.08), rand((2, H, 4 * H), 0.05)
        bias = rand((2, 4 * H), 0.05, torch.float32)
        with torch.no_grad():
            times = {"K5": event_ms(lambda: recurrence_form(x, w_ih, w_hh, bias), 10),
                     "K6": event_ms(lambda: resident_bilstm(x, w_ih, w_hh, bias), 10),
                     "plain": event_ms(lambda: resident_bilstm_reference(x, w_ih, w_hh, bias), 1)}
            lstm = torch.nn.LSTM(Din, H, batch_first=True, bidirectional=True).to(dev, torch.bfloat16)
            info = {"nn.LSTM": event_ms(lambda: lstm(x), 5)}
        rows.append({"rule": "lstm", "name": name, "shape": (T, B, Din, H), "times": times, "info": info,
                     "choice": kernel_choice(B, Din) if lstm_kernel_ok(H) else "plain"})
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
