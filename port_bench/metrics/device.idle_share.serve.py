"""device.idle_share.serve (layer: device; moves serve_audio_s_per_s): the
share of the traced stretch in which no operation ran on the card, from
the union of the device operations' intervals on the trace's timeline."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
