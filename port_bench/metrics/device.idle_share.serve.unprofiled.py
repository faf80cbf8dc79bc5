"""device.idle_share.serve.unprofiled (layer: device; moves
serve_audio_s_per_s): 100 x (1 - the card's busy ms a traced request over
the mean interval between the starts of the last 128 untraced requests'
``serve.call`` spans): the share of a request's period the card idles as
an untraced run paces it.  The card's work a request comes from the trace
(the union of the device operations' intervals over the traced requests),
the period from the port's span ring (``port_bench/ring.py``).  Its
profiled twin is ``device.idle_share.serve``."""

from port_bench import ring, spans


def read(ctx):
    got = ring.requests(ctx)
    return ring.idle_share(ctx, got and got[0], spans.traced_requests(ctx))
