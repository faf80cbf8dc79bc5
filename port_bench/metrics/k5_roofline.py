"""k5_roofline (layer: kernels, K5: ``ops/kernels/lstm.py::fused_bilstm``,
``csrc/lstm.cu``; moves serve_audio_s_per_s): the least time of every K5
launch of the traced requests at their padded shapes (the reference's
``lstm_shapes``: BSRNN's band RNNs; ``lstm_work.recurrence_work``), over
the device time of ``lstm_recurrence_kernel`` in the trace.  None where no
such kernel ran."""

from port_bench.lstm_work import recurrence_work, roofline


def read(ctx):
    return roofline(ctx, "lstm_recurrence_kernel", "K5", recurrence_work)
