"""addnorm_roofline (layer: kernels, K8: ``ops/kernels/add_layer_norm.py``,
``csrc/add_layer_norm.cu``; moves serve_audio_s_per_s): the least time of
every residual add + LayerNorm site of the traced requests at their padded
shapes (``addnorm_work.addnorm_shapes``, ``addnorm_work``: the bytes alone),
over the device time of ``add_layer_norm_kernel`` in the trace.  None where
no such kernel ran (a program without K8)."""

from port_bench.addnorm_work import addnorm_shapes, addnorm_work
from port_bench.bounds import least_time

KERNELS = ("add_layer_norm_kernel",)


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
        least += sum(least_time(*addnorm_work(*site))[0] for site in addnorm_shapes(a, len(req), T))
    return 100.0 * least / spent
