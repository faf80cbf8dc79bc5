"""The yardstick's peaks and least times, worked out from shapes alone.

Frozen copies of ``chip_smoke.py``'s ``least_time``, ``separator_work``
and ``chain_work``, so that no later change to the program or its scripts
moves a roofline's denominator.  One departure: ``chain_work`` counts the
TCN chain's backward as the 4 products its gradients need (two input
gradients, two weight gradients), not the 5 that K3 runs (it also
recomputes the first 1x1); ``products=5`` gives ``chip_smoke.py``'s count.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the 700 W
limit.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense tensor-core peak, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s


def least_time(nbytes: float, flops: float):
    """(least seconds the card could take, "bytes" or "operations"): the
    larger of the bytes over HBM bandwidth and the FLOPs over the bf16
    peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def separator_work(B, T, N=512, C=128, nb=24, spk=3, win=16):
    """(bytes, FLOPs) of ConvTasNet's whole separator (K1) on [B, T, win]
    frames: frames in and decoder frames out once (bf16), the weights once;
    the products of the encoder, bottleneck, nb blocks (two 1x1s each),
    mask head and decoder, and the depthwise taps."""
    flops = B * T * (2 * win * N + 2 * N * C + nb * (2 * 2 * C * N + 6 * N)
                     + 2 * C * spk * N + 2 * spk * N * win)
    weights = (nb + 1) * (2 * C * N * 2 + 8 * N * 4 + 2 * C * 4 + 8) + 2 * win * N * 2 + C * spk * N * 6
    return B * T * win * 2 * (1 + spk) + weights, flops


def chain_work(B, T, nb=24, H=512, C=128, products=2):
    """(bytes, FLOPs) of the TCN chain forward (K2, ``products=2`` a block)
    or backward (``products=4``: two input gradients, two weight
    gradients): x and the cotangent or y in, y / dx and the saved history
    out once."""
    tpad = -(-T // 64) * 64
    weights = nb * (2 * C * H * 2 + 8 * H * 4 + 2 * C * 4 + 8)
    nbytes = 2 * B * T * C * 2 + B * nb * tpad * C * 2 + B * nb * 16 + weights * (1 if products == 2 else 2)
    return nbytes, B * T * nb * (products * 2 * C * H + 6 * H)
