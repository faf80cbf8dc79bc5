"""serve.host_ms.unprofiled (layer: serving loop; moves
serve_audio_s_per_s): the mean over the last 128 untraced requests of the
port's ``serve.call`` span less its ``serve.forward`` and ``serve.d2h``, read
from the port's span ring with no profiler on (``port_bench/ring.py``): the
host's own work in ``Server.__call__`` outside the forward's issue and the
wait for the card.  Its profiled twin is ``serve.host_ms``."""

from port_bench import ring


def read(ctx):
    return ring.request_ms(ctx, ("serve.call",), less=("serve.forward", "serve.d2h"))
