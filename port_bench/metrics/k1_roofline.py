"""k1_roofline (layer: kernels, K1: ``ops/kernels/convtasnet_block.py``,
``csrc/convtasnet_separator.cu``; moves serve_audio_s_per_s): the least
time of ConvTasNet's whole separator at each traced request's padded
shape (``bounds.separator_work``), over the device time of K1's kernels in
the trace."""

from port_bench.bounds import least_time, separator_work

KERNELS = ("encoder_kernel", "block_p1_kernel", "block_p2_kernel", "head_kernel")


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
        frames = ctx.cell.ref.frames(a, -(-max(req) // bucket) * bucket)
        least += least_time(*separator_work(len(req), frames, N=a["N"], C=a["B"], nb=a["R"] * a["X"],
                                            spk=a["num_spks"], win=a["L"]))[0]
    return 100.0 * least / spent
