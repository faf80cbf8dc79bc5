"""serve.gln_launches (layer: kernels; moves serve_audio_s_per_s): the
device operations named ``gln_apply_kernel`` (K9's second pass, one a gLN)
in the traced stretch over the traced requests; a Sandglasset request of
6 blocks runs 15 gLNs (``enc_LN``, ``seg_norm``, 12 with a block's
residual, ``out_norm``).  None where no such kernel ran (a program without
K9)."""


def read(ctx):
    tr = ctx.trace
    n = len(ctx.read.get("traced", {}).get("requests", []))
    if tr is None or not tr.device or not n:
        return None
    count = sum(1 for name, _, _ in tr.device if name == "gln_apply_kernel")
    return count / n if count else None
