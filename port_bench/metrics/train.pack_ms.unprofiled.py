"""train.pack_ms.unprofiled (layer: model forward; moves
train_audio_s_per_s): the mean of the port's last 128 untraced
``train.pack`` spans (the fused train form's weight packing, as the host
issues it), read from the port's span ring with no profiler on
(``port_bench/ring.py``).  Its profiled twin is ``train.pack_ms``."""

from port_bench import ring


def read(ctx):
    return ring.mean_ms(ctx, "train.pack")
