"""serve.addnorm_launches (layer: kernels; moves serve_audio_s_per_s): the
device operations named ``add_layer_norm_kernel`` (K8) in the traced
stretch over the traced requests; Sepformer's four pre-norm stacks of 8
layers launch 17 each (68 a request).  None where no such kernel ran (a
program without K8)."""


def read(ctx):
    tr = ctx.trace
    n = len(ctx.read.get("traced", {}).get("requests", []))
    if tr is None or not tr.device or not n:
        return None
    count = sum(1 for name, _, _ in tr.device if name == "add_layer_norm_kernel")
    return count / n if count else None
