"""device.idle_share.train.unprofiled (layer: device; moves
train_audio_s_per_s): 100 x (1 - the card's busy ms a traced step over the
mean interval between the starts of the last 128 untraced ``train.forward``
spans): the share of a step's period the card idles as an untraced run
paces it.  The card's work a step comes from the trace, the period from
the port's span ring (``port_bench/ring.py``).  Its profiled twin is
``device.idle_share.train``."""

from port_bench import ring, spans


def read(ctx):
    return ring.idle_share(ctx, ring.last(ctx, "train.forward"), spans.traced_steps(ctx))
