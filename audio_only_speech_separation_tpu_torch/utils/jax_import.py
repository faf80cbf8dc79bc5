"""JAX parameter tree -> port ``state_dict`` (the inverse of the JAX
package's ``utils/torch_import.py`` converters).

Takes the nested ``{"params": {...}}`` tree as numpy arrays, as a JAX
checkpoint unpickles, and returns ``{look2hear key: np.ndarray}``.
Layouts translated:

- encoder kernel [win, N] -> ``encoder._filters`` [N, 1, win]
- decoder kernel [N, win] -> ``decoder._filters`` [N, 1, win]
- pointwise kernel [in, out] -> Conv1d weight [out, in, 1]
- depthwise kernel [3, 1, H] -> Conv1d weight [H, 1, 3]
- PReLU alpha [1] -> weight [1]
- gLN gamma/beta [C] and cLN gain/bias [1, C, 1] -> weight/bias [C]
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _pointwise(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{prefix}.bias"] = _f32(p["bias"])


def _norm(sd, prefix: str, p) -> None:
    if "gamma" in p:
        w, b = p["gamma"], p["beta"]
    else:
        w, b = p["gain"], p["bias"]
    sd[f"{prefix}.weight"] = _f32(w).reshape(-1)
    sd[f"{prefix}.bias"] = _f32(b).reshape(-1)


def convtasnet_from_jax(params_np, R: int, X: int) -> Dict[str, np.ndarray]:
    """JAX ConvTasNet params -> port ConvTasNet ``state_dict`` (numpy)."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    sd["encoder._filters"] = _f32(np.asarray(p["encoder"]["kernel"]).T[:, None, :])
    _norm(sd, "bottleneck.0", p["bn_norm"])
    _pointwise(sd, "bottleneck.1", p["bn_conv"])
    for r in range(R):
        for i in range(X):
            blk = p[f"tcn_{r}_{i}"]
            pre = f"separation.sep.{r}.tcn.{i}"
            _pointwise(sd, f"{pre}.conv1x1", blk["conv1x1"])
            sd[f"{pre}.prelu1.weight"] = _f32(blk["act1"]["alpha"]).reshape(1)
            _norm(sd, f"{pre}.norm1", blk["norm1"])
            dw = blk["dwconv"]["Conv_0"]
            sd[f"{pre}.dwconv.weight"] = _f32(np.transpose(np.asarray(dw["kernel"]), (2, 1, 0)))
            sd[f"{pre}.dwconv.bias"] = _f32(dw["bias"])
            sd[f"{pre}.prelu2.weight"] = _f32(blk["act2"]["alpha"]).reshape(1)
            _norm(sd, f"{pre}.norm2", blk["norm2"])
            _pointwise(sd, f"{pre}.sconv", blk["sconv"])
    _pointwise(sd, "mask", p["mask_conv"])
    sd["decoder._filters"] = _f32(np.asarray(p["decoder"]["kernel"])[:, None, :])
    return sd


def from_jax(model, params_np) -> Dict[str, np.ndarray]:
    """Convert a JAX tree for ``model`` (a port model instance)."""
    name = type(model).__name__
    if name == "ConvTasNet":
        return convtasnet_from_jax(params_np, model.R, model.X)
    raise NotImplementedError(f"no JAX converter for {name}")
