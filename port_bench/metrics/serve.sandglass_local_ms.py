"""serve.sandglass_local_ms (layer: model forward; moves serve_audio_s_per_s):
the device milliseconds, a traced request, of the operations the host
issued inside the port's ``sandglasset.local`` spans
(``models/sandglasset.py::SandglassetBlock.forward``, one a block: the
intra BiLSTM through K6 with its projection, ``intra_norm`` and the
residual), each operation paired with its launch by
``port_bench/span_device.py``; None where the program has no such span or
the pairing fails."""

from port_bench.span_device import span_device_ms


def read(ctx):
    return span_device_ms(ctx, "sandglasset.local")
