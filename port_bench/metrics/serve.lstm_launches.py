"""serve.lstm_launches (layer: kernels; moves serve_audio_s_per_s): the
device operations named ``lstm_recurrence_kernel`` (K5) or
``lstm_resident_kernel`` (K6) in the traced stretch over the traced
requests; a BSRNN request launches 16 (K5 for each of its 8 BSNets' band
RNNs, K6 for each band-comm RNN), and none where the dispatch takes the
plain LSTM."""

KERNELS = ("lstm_recurrence_kernel", "lstm_resident_kernel")


def read(ctx):
    tr = ctx.trace
    n = len(ctx.read.get("traced", {}).get("requests", []))
    if tr is None or not tr.device or not n:
        return None
    return sum(1 for name, _, _ in tr.device if name in KERNELS) / n
