"""train.forward_issue_ms (layer: model forward; moves train_audio_s_per_s):
the mean over the traced steps of the port's ``train.forward`` span
(``TrainForward.forward``: the seeding, the bf16 casts, the weight packing,
K2 and the plain ops around it, as the host issues them)."""

from port_bench import spans


def read(ctx):
    return spans.per_item_ms(ctx, "train.forward", spans.traced_steps(ctx))
