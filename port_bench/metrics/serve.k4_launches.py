"""serve.k4_launches (layer: kernels; moves serve_audio_s_per_s): the
device operations named ``attention_kernel`` (K4) in the traced stretch
over the traced requests; Sepformer's 32 transformer layers launch one
each, and none where the dispatch takes the plain attention form."""


def read(ctx):
    tr = ctx.trace
    n = len(ctx.read.get("traced", {}).get("requests", []))
    if tr is None or not tr.device or not n:
        return None
    return sum(1 for name, _, _ in tr.device if name == "attention_kernel") / n
