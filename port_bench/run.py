"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the port (``audio_only_speech_separation_tpu_torch``), on a machine with
as many CUDA cards as the cell asks for.  ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` trace of the window's last ``trace_seconds``.  The last
line of standard output is one JSON object; the last lines of standard
error give each number compared beside its limit.  Without a card, or
with fewer than the cell asks for, it exits with 2 and prints no result;
if JAX, flax or the JAX package was loaded, with 3.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"port_bench: {msg}", file=sys.stderr)
    return code


def per_layer(cell, run):
    """{metric: value} of the cell's per-layer metrics whose readers found
    something to read."""
    from . import harness

    ctx = SimpleNamespace(cell=cell, read=run.read, trace=run.trace)
    out = {}
    for m in cell.per_layer:
        value = harness.load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = (value, m["unit"])
    return out


def result_line(cell, run, trace: bool, bench: dict) -> dict:
    from . import harness

    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if trace:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in per_layer(cell, run).items()}
    else:
        metrics = {k: {"value": run.end_to_end[k], "unit": units[k]} for k in cell.end_to_end}
    device = dict(run.device)
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
    device["power_limit"] = harness.power_limit()
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in run.checks.items()}
    correct = (run.attempted > 0 and run.failed == 0
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
               and all(math.isfinite(m["value"]) for m in metrics.values()))
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": device}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = checks
    return _finite(line)


def _finite(x):
    """``x`` with every non-finite number as null, so that the line stays
    JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return None if isinstance(x, float) and not math.isfinite(x) else x


def main(argv=None) -> int:
    args = parse(argv)
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    import torch

    from . import harness

    bench = harness.load_json(CHECKOUT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, bench)
    if not torch.cuda.is_available():
        return fail(2, "no CUDA device: the benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell.chips:
        return fail(2, f"{cell.name} needs {cell.chips} CUDA devices, {torch.cuda.device_count()} found")
    torch.set_num_threads(4)
    mode = importlib.import_module(f"port_bench.modes.{cell.traffic['mode']}")
    importlib.import_module("audio_only_speech_separation_tpu_torch.serve")
    importlib.import_module("audio_only_speech_separation_tpu_torch.train")
    found = harness.forbidden_loaded()
    if found:
        return fail(3, f"loaded after set-up: {', '.join(found)}")
    run = mode.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    line = result_line(cell, run, bool(args.trace), bench)
    found = harness.forbidden_loaded()
    if found:
        return fail(3, f"loaded once the window had closed: {', '.join(found)}")
    print("set-up, seconds from start: " + ", ".join(f"{k} {v:.3f}" for k, v in run.read.get("setup_phases", [])),
          file=sys.stderr)
    if "comparison" in run.read:
        print(f"comparison: {json.dumps(run.read['comparison'])}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
