"""train.backward_ms (layer: train loop, ``loss.backward()``; moves
train_audio_s_per_s): the mean time between CUDA events recorded around
the benchmark's own call to ``loss.backward()``, over the steps of the
untraced part of a ``--trace 1`` window."""


def read(ctx):
    ms = ctx.read.get("backward_ms") or []
    return sum(ms) / len(ms) if ms else None
