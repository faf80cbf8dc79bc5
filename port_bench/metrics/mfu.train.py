"""mfu.train (layer: whole step, ``train.trainer.TrainForward``, loss,
backward, optimizer; moves train_audio_s_per_s): 3 x the configuration's
forward FLOPs (forward, and the two products of the backward a product)
at the batch and segment, times the steps of the untraced part of the
window, over that part's wall time, as a share of the card's bf16 dense
peak (``bounds.PEAK_FLOPS``).  It is the training rate in units of the
peak, host work included, by design: the whole step's share that bounds
the kernels' rooflines."""

from port_bench.bounds import PEAK_FLOPS


def read(ctx):
    part = ctx.read.get("untraced", {})
    if not part.get("steps") or part["seconds"] <= 0:
        return None
    cell = ctx.cell
    T = int(round(cell.traffic["segment_s"] * cell.cfg["sample_rate"]))
    flops = 3 * cell.ref.forward_flops(cell.cfg["model_args"], T) * cell.traffic["batch"] * part["steps"]
    return 100.0 * flops / part["seconds"] / PEAK_FLOPS
