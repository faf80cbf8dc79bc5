"""K8's work (``ops/kernels/add_layer_norm.py``, ``csrc/add_layer_norm.cu``),
from shapes alone, for ``metrics/addnorm_roofline.py``: the sites of
Sepformer's pre-norm stacks (``addnorm_shapes``) and the bytes each needs
(``addnorm_work``); its least time is ``bounds.least_time`` of it."""

from __future__ import annotations

from typing import List, Tuple

from port_bench.reference.sepformer import chunks, frames


def addnorm_shapes(cfg, batch: int, T: int) -> List[Tuple[int, int, int, bool]]:
    """(rows, d, addend rows, the sum written) of every residual add +
    LayerNorm site of one forward of ``batch`` waves of T samples, in order:
    per dual block the intra stack's (batch x S chunks of K frames) and
    then the inter stack's (batch x K positions of S chunks).  A pre-norm
    stack has 1 + 2 x layers sites: its positions [length, d] added to its
    input before the first ``norm1``; each layer's attention and feed-forward
    sums, each before the next LayerNorm; at the last, the stack's final
    norm, whose sum is not kept.  A stack without positions starts at its
    first residual site; a post-norm stack has none."""
    N, K = cfg["encoder_out_nchannels"], cfg["masknet_chunksize"]
    S = chunks(cfg, frames(cfg, T))
    rows = batch * S * K
    out = []
    for _ in range(cfg["masknet_numlayers"]):
        for side, length in (("intra", K), ("inter", S)):
            if not cfg.get(f"{side}_norm_before", True):
                continue
            if cfg.get(f"{side}_use_positional", True):
                out.append((rows, N, length, True))
            out += [(rows, N, rows, True)] * (2 * cfg[f"{side}_numlayers"] - 1) + [(rows, N, rows, False)]
    return out


def addnorm_work(rows: int, d: int, addend_rows: int, writes_sum: bool):
    """(bytes, FLOPs) of one site in bf16: x and the addend read once, the
    LayerNorm written once, and the sum where it is kept.  FLOPs 0: a site
    is a few elementwise operations an element and no product, so its least
    time is the bytes'."""
    return 2 * d * (2 * rows + addend_rows + (rows if writes_sum else 0)), 0
