"""train.pack_ms (layer: model forward; moves train_audio_s_per_s): the
mean over the traced steps of the port's ``train.pack`` span (the fused
train form's weight packing: the parameters' bf16 rounding and the folds
into the kernels' layout, as the host issues them)."""

from port_bench import spans


def read(ctx):
    return spans.per_item_ms(ctx, "train.pack", spans.traced_steps(ctx))
