"""k6_roofline (layer: kernels, K6: ``ops/kernels/lstm.py::resident_bilstm``,
``csrc/lstm.cu``; moves serve_audio_s_per_s): the least time of every K6
launch of the traced requests at their padded shapes (the reference's
``lstm_shapes``: BSRNN's band-comm RNNs; ``lstm_work.resident_work``),
over the device time of ``lstm_resident_kernel`` in the trace.  None where
no such kernel ran."""

from port_bench.lstm_work import resident_work, roofline


def read(ctx):
    return roofline(ctx, "lstm_resident_kernel", "K6", resident_work)
