"""serve.transformer_issue_ms.unprofiled (layer: model forward; moves
serve_audio_s_per_s): the summed ``sepformer.intra`` and ``sepformer.inter``
spans of a request (each transformer stack's issue, K4's and K8's launches
included), the mean over the last 128 untraced requests, read from the
port's span ring with no profiler on (``port_bench/ring.py``); None where
the requests hold no such span.  Its profiled twin is
``serve.transformer_issue_ms``."""

from port_bench import ring


def read(ctx):
    return ring.request_ms(ctx, ("sepformer.intra", "sepformer.inter"))
