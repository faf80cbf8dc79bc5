"""mfu.serve (layer: whole step, a request through ``serve.Server``;
moves serve_audio_s_per_s): the configuration's forward FLOPs at each served
utterance's own length (not the padded one), summed over the requests of
the untraced part of the window, over that part's wall time, as a share
of the card's bf16 dense peak (``bounds.PEAK_FLOPS``).  It is the served
rate in units of the peak, host work included, by design: the whole
step's share that bounds the kernels' rooflines."""

from port_bench.bounds import PEAK_FLOPS


def read(ctx):
    part = ctx.read.get("untraced", {})
    if not part.get("requests") or part["seconds"] <= 0:
        return None
    args = ctx.cell.cfg["model_args"]
    flops = sum(ctx.cell.ref.forward_flops(args, T) for req in part["requests"] for T in req)
    return 100.0 * flops / part["seconds"] / PEAK_FLOPS
