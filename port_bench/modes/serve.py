"""Serving: one client in a closed loop through ``serve.Server.__call__``,
as the port's eval CLI separates a test set.

Set-up makes the weights and a pool of requests from the seed, builds the
server (its dispatch, packed weights or bf16 copy) and warms up every
padded shape the pool holds.  The window sends the pool's requests in an
order drawn from the seed, one at a time, each timed from the call until
its estimates are numpy arrays on the host.  After the window a sample of
the answers, drawn from the seed and holding the longest utterance
served, is compared with the float32 reference run on the same padded
mix and cropped as the server crops.

Traffic parameters (``traffic/<name>.json``): ``batch`` utterances a
request; ``gain_db``: the sources' levels, uniform in +- that;
``lengths``: ``{"fixed_s": x}``, every utterance x seconds long; ``pool``
requests; ``bucket_seconds`` (the server's padding); ``check_requests``
answers compared; ``trace_seconds`` traced at the end of a ``--trace 1``
window.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import harness, trace as tracing
from . import Run


def pool_lengths(traffic: dict, sample_rate: int) -> List[int]:
    """The samples of every utterance of the pool, in pool order."""
    return [int(round(traffic["lengths"]["fixed_s"] * sample_rate))] * (traffic["pool"] * traffic["batch"])


def padded(T: int, bucket: int) -> int:
    return -(-T // bucket) * bucket


class Traffic:
    """The pool of requests: numpy mixes on the host, made on the device
    from the seed; request ``r`` of the window is pool item ``order[r]``."""

    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.cfg, cell.traffic
        self.batch = tr["batch"]
        self.lengths = pool_lengths(tr, cfg["sample_rate"])
        self.bucket = max(1, int(tr["bucket_seconds"] * cfg["sample_rate"]))
        total = sum(self.lengths)
        mix = harness.sources(1, cfg["n_src"], total, seed, device, tr["gain_db"]).sum(dim=1)[0].cpu().numpy()
        cuts = np.cumsum([0] + self.lengths)
        utts = [mix[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        self.requests = [utts[i:i + self.batch] for i in range(0, len(utts), self.batch)]
        self.rng = np.random.default_rng(harness.subseed(seed, harness.ORDER))
        self._order: List[int] = []

    def item(self, r: int) -> int:
        """The pool item of the window's request ``r``: cycles through the
        pool, each cycle in an order drawn from the seed."""
        while r >= len(self._order):
            self._order += self.rng.permutation(len(self.requests)).tolist()
        return self._order[r]


def answer_ok(req, out, n_src: int) -> bool:
    return len(out) == len(req) and all(o.shape == (n_src, len(u)) for u, o in zip(req, out))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    from audio_only_speech_separation_tpu_torch.serve import Server

    cfg, tr = cell.cfg, cell.traffic
    n_src = cfg["n_src"]
    phases = [("imports", time.perf_counter() - t_start)]
    sd = harness.make_state_dict(cell.ref, cfg["model_args"], seed, device)
    model = harness.build_model(cfg, sd, device)
    server = Server(model, use_bf16=cfg["precision"] == "bfloat16", device=device,
                    bucket_seconds=tr["bucket_seconds"])
    phases.append(("weights and server", time.perf_counter() - t_start))
    traffic = Traffic(cell, seed, device)
    phases.append(("traffic", time.perf_counter() - t_start))
    by_shape = {}
    for i, q in enumerate(traffic.requests):
        by_shape.setdefault((len(q), padded(max(len(u) for u in q), traffic.bucket)), i)
    for i in by_shape.values():  # every padded shape of the pool, twice
        server(traffic.requests[i])
        server(traffic.requests[i])
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases.append(("warm-up", time.perf_counter() - t_start))

    latencies: List[float] = []
    answers: Dict[int, list] = {}
    failed = 0
    audio_s = 0.0
    untraced = {"requests": [], "seconds": 0.0}
    traced = {"requests": []}
    traced_holder = None
    sr = cfg["sample_rate"]
    plain_until = seconds - (tr["trace_seconds"] if trace else 0.0)

    setup_s = time.perf_counter() - t_start
    t0 = time.perf_counter()
    r = 0

    def one(r: int, record: list, on: bool):
        nonlocal failed, audio_s
        i = traffic.item(r)
        req = traffic.requests[i]
        with tracing.span(on, "request"):
            a = time.perf_counter()
            out = server(req)
            latencies.append(time.perf_counter() - a)
        with tracing.span(on, "client"):
            if answer_ok(req, out, n_src):
                answers[i] = out
                audio_s += sum(len(u) for u in req) / sr
            else:
                failed += 1
            record.append([len(u) for u in req])

    while time.perf_counter() - t0 < plain_until:
        one(r, untraced["requests"], False)
        r += 1
    t1 = time.perf_counter()
    untraced["seconds"] = t1 - t0
    if trace:  # the traced stretch is timed from its own start: the profiler takes a while to start
        with tracing.profiled() as traced_holder:
            with torch.profiler.record_function(tracing.WINDOW):
                t2 = time.perf_counter()
                while time.perf_counter() - t2 < tr["trace_seconds"]:
                    one(r, traced["requests"], True)
                    r += 1
    elapsed = time.perf_counter() - t0

    device_info = harness.device_info(cell.chips) if device.type == "cuda" else {}
    e2e = {"setup_s": setup_s, "serve_audio_s_per_s": audio_s / elapsed,
           "serve_p95_ms": harness.percentile(latencies, 95) * 1e3}
    del server, model
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = {"serve_rel_err": check(cell, sd, traffic, answers, seed, device)}
    read = {"untraced": untraced, "traced": traced, "bucket": traffic.bucket, "setup_phases": phases}
    return Run(attempted=r, failed=failed, end_to_end=e2e, checks=checks, read=read,
               trace=traced_holder.trace if traced_holder else None, device=device_info)


def check_sample(traffic: Traffic, answers: Dict[int, list], n: int, seed: int) -> List[int]:
    """The requests compared: ``n`` of those answered, drawn from the seed,
    and the one holding the longest utterance answered."""
    done = sorted(answers)
    if not done:
        return []
    rng = np.random.default_rng(harness.subseed(seed, harness.SAMPLE))
    pick = set(rng.choice(done, size=min(n, len(done)), replace=False).tolist())
    pick.add(max(done, key=lambda i: max(len(u) for u in traffic.requests[i])))
    return sorted(pick)


def check(cell, sd, traffic: Traffic, answers: Dict[int, list], seed: int, device) -> float:
    """The largest relative l2 error of an answer of the sample against
    the reference, every answer of a request padded as the server pads it;
    inf when nothing was answered."""
    from ..reference.common import exact_f32

    exact_f32()
    worst = float("inf") if not answers else 0.0
    for i in check_sample(traffic, answers, cell.traffic["check_requests"], seed):
        worst = max(worst, request_error(cell, sd, traffic, traffic.requests[i], answers[i], device))
    return worst


def reference_answers(cell, sd, traffic: Traffic, req, device, q=None) -> List[np.ndarray]:
    """The reference's answers to one request, padded and cropped as the
    server does."""
    T_pad = padded(max(len(u) for u in req), traffic.bucket)
    mix = np.zeros((len(req), T_pad), np.float32)
    for j, u in enumerate(req):
        mix[j, :len(u)] = u
    with torch.no_grad():
        est = cell.ref.forward(sd, torch.from_numpy(mix).to(device), cell.cfg["model_args"], q).cpu().numpy()
    return [est[j, :, :len(u)] for j, u in enumerate(req)]


def request_error(cell, sd, traffic, req, out, device, q=None) -> float:
    """The largest relative l2 error of ``out``, the answers to ``req``,
    against the reference's; with ``q`` (the control) the reference's own
    answers with its products through ``q`` stand in for ``out``."""
    ref = reference_answers(cell, sd, traffic, req, device)
    got = out if q is None else reference_answers(cell, sd, traffic, req, device, q)
    return max(harness.rel_l2(g, w) for g, w in zip(got, ref))
