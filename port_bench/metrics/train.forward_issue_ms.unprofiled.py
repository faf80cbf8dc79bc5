"""train.forward_issue_ms.unprofiled (layer: model forward; moves
train_audio_s_per_s): the mean of the port's last 128 untraced
``train.forward`` spans (``TrainForward.forward``, as the host issues it),
read from the port's span ring with no profiler on
(``port_bench/ring.py``).  Its profiled twin is ``train.forward_issue_ms``."""

from port_bench import ring


def read(ctx):
    return ring.mean_ms(ctx, "train.forward")
