"""serve.transformer_issue_ms (layer: model forward; moves
serve_audio_s_per_s): the summed ``sepformer.intra`` and
``sepformer.inter`` spans of the port (``DualComputationBlock.forward``:
the host's issue of each transformer stack, K4's launches included) over
the traced requests; None where the program has no such span."""

from port_bench import spans


def read(ctx):
    n = spans.traced_requests(ctx)
    parts = [spans.per_item_ms(ctx, f"sepformer.{side}", n) for side in ("intra", "inter")]
    return None if None in parts else sum(parts)
