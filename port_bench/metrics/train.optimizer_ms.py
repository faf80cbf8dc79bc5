"""train.optimizer_ms (layer: optimizer; moves train_audio_s_per_s): the
mean over the traced steps of the port's ``optim.step`` span
(``Optimizer.step``: the global-norm clip and Adam's update)."""

from port_bench import spans


def read(ctx):
    return spans.per_item_ms(ctx, "optim.step", spans.traced_steps(ctx))
