"""serve.forward_issue_ms (layer: model forward; moves serve_audio_s_per_s):
the mean over the traced requests of the port's ``serve.forward`` span:
the host's time to issue the forward (``Server.forward``: ``eval_mode``,
the bf16 cast, the framing, K1's launches, the overlap-add)."""

from port_bench import spans


def read(ctx):
    return spans.per_item_ms(ctx, "serve.forward", spans.traced_requests(ctx))
