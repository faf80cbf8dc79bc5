"""k4_roofline (layer: kernels, K4: ``ops/kernels/attention.py``,
``csrc/attention.cu``; moves serve_audio_s_per_s): the least time of every
attention of the traced requests at their padded shapes (the reference's
``attention_shapes``: Sepformer's intra and inter stacks;
``attention_work``), over the device time of ``attention_kernel`` in the
trace."""

from port_bench.attention_work import attention_work
from port_bench.bounds import least_time

KERNELS = ("attention_kernel",)


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
        least += sum(least_time(*attention_work(*shape))[0] for shape in ctx.cell.ref.attention_shapes(a, len(req), T))
    return 100.0 * least / spent
