"""serve.forward_issue_ms.unprofiled (layer: model forward; moves
serve_audio_s_per_s): the mean over the last 128 untraced requests of the
port's ``serve.forward`` span, read from the port's span ring with no
profiler on (``port_bench/ring.py``): the host's time to issue the forward.
Its profiled twin is ``serve.forward_issue_ms``."""

from port_bench import ring


def read(ctx):
    return ring.request_ms(ctx, ("serve.forward",))
