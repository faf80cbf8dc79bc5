"""gln_roofline (layer: kernels, K9: ``ops/kernels/global_layer_norm.py``,
``csrc/global_layer_norm.cu``; moves serve_audio_s_per_s): the least time
of every gLN of the traced requests at their padded shapes
(``gln_work.gln_shapes``, ``gln_work``: the bytes alone, x, the residual
and y once each), over the device time of ``gln_stats_kernel`` and
``gln_apply_kernel`` in the trace.  None where no such kernel ran (a
program without K9)."""

from port_bench.bounds import least_time
from port_bench.gln_work import gln_shapes, gln_work

KERNELS = ("gln_stats_kernel", "gln_apply_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    spent = tr.device_seconds(KERNELS)
    if spent <= 0:
        return None
    a = ctx.cell.cfg["model_args"]
    bucket = ctx.read["bucket"]
    least = 0.0
    for req in ctx.read["traced"]["requests"]:
        T = -(-max(req) // bucket) * bucket
        least += sum(least_time(*gln_work(*g))[0] for g in gln_shapes(a, len(req), T))
    return 100.0 * least / spent
