"""train.optimizer_ms.unprofiled (layer: optimizer; moves
train_audio_s_per_s): the mean of the port's last 128 untraced
``optim.step`` spans (``Optimizer.step``: the global-norm clip and Adam's
update), read from the port's span ring with no profiler on
(``port_bench/ring.py``).  Its profiled twin is ``train.optimizer_ms``."""

from port_bench import ring


def read(ctx):
    return ring.mean_ms(ctx, "optim.step")
