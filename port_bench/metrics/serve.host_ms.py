"""serve.host_ms (layer: serving loop; moves serve_audio_s_per_s): the mean
over the traced requests of the port's ``serve.call`` span less its
``serve.forward`` and ``serve.d2h``: the host's own work in
``Server.__call__`` (the pad, the copy in, the crop, the glue) outside the
forward's issue and the wait for the card."""

from port_bench import spans


def read(ctx):
    return spans.per_item_ms(ctx, "serve.call", spans.traced_requests(ctx), less=("serve.forward", "serve.d2h"))
