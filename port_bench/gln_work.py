"""K9's work (``ops/kernels/global_layer_norm.py``,
``csrc/global_layer_norm.cu``), from shapes alone, for
``metrics/gln_roofline.py``: the gLNs of a Sandglasset forward
(``gln_shapes``) and the bytes each needs (``gln_work``); its least time
is ``bounds.least_time`` of it."""

from __future__ import annotations

from typing import List, Tuple

from port_bench.reference.sandglasset import chunks, frames


def gln_shapes(cfg, batch: int, T: int) -> List[Tuple[int, int, bool]]:
    """(samples, elements a sample, a residual added) of every gLN of one
    forward of ``batch`` waves of T samples, in order: ``enc_LN`` over the
    encoding [batch, I, N]; ``seg_norm`` over the block tensor [batch, S,
    K, D]; per block ``intra_norm`` and ``inter_norm`` over it, each with
    the block's residual; ``out_norm`` over the masks [batch x speakers,
    I, N]."""
    N, D, K, spk = cfg["n_feats"], cfg["bn_chan"], cfg["chunk_size"], cfg["n_src"]
    I = frames(cfg, T)
    block = chunks(cfg, I) * K * D
    return ([(batch, I * N, False), (batch, block, False)] + [(batch, block, True)] * (2 * cfg["n_repeats"])
            + [(batch * spk, I * N, False)])


def gln_work(samples: int, n: int, residual: bool):
    """(bytes, FLOPs) of one gLN in bf16: x read and y written once, and the
    residual read once where it is added.  FLOPs 0: a gLN is a few
    elementwise operations an element and no product, so its least time is
    the bytes'."""
    return 2 * samples * n * (3 if residual else 2), 0
