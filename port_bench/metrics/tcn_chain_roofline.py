"""tcn_chain_roofline (layer: kernels, K2 + K3:
``csrc/convtasnet_separator.cu``, ``csrc/convtasnet_backward.cu``; moves
train_audio_s_per_s): the least time of the TCN chain's forward (2
products a block) and backward (4) at the step's shape
(``bounds.chain_work``), times the traced steps, over the device time of
K2's and K3's kernels in the trace."""

from port_bench.bounds import chain_work, least_time

K2 = ("block_p1_kernel", "block_p2_kernel", "tcn_epilogue_kernel")
K3 = ("bwd_p1_kernel", "bwd_p2_kernel", "bwd_p3_kernel", "stats1_finish_kernel", "stats2_finish_kernel",
      "wgrad_kernel", "block_finish_kernel", "sum_samples_kernel")


def read(ctx):
    tr = ctx.trace
    steps = ctx.read.get("traced", {}).get("steps", 0)
    if tr is None or not steps:
        return None
    spent = tr.device_seconds(K2 + K3)
    if spent <= 0:
        return None
    cell = ctx.cell
    a = cell.cfg["model_args"]
    T = cell.ref.frames(a, int(round(cell.traffic["segment_s"] * cell.cfg["sample_rate"])))
    B, nb = cell.traffic["batch"], a["R"] * a["X"]
    least = sum(least_time(*chain_work(B, T, nb=nb, H=a["H"], C=a["B"], products=p))[0] for p in (2, 4))
    return 100.0 * least * steps / spent
