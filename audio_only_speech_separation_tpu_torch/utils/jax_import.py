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
- LSTM w_ih/w_hh [D, in, 4H] -> ``weight_{ih,hh}_l0[_reverse]`` [4H, in];
  the folded bias [D, 4H] -> ``bias_ih_*``, zeros in ``bias_hh_*``
- dense kernel [in, out] -> Linear weight [out, in]; LayerNorm scale -> weight
- dual-path gate weight [C] -> Conv2d weight [C, 1, 1, 1]; core
  ``out_kernel`` [in, out] -> Conv2d weight [out, in, 1, 1]
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


def _dense(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _f32(p["bias"])


def _lstm(sd, prefix: str, p) -> None:
    w_ih, w_hh, bias = (np.asarray(p[k]) for k in ("w_ih", "w_hh", "bias"))
    if w_ih.ndim == 2:  # one direction: [in, 4H]
        w_ih, w_hh, bias = w_ih[None], w_hh[None], bias[None]
    for d, s in zip(range(w_ih.shape[0]), ("", "_reverse")):
        sd[f"{prefix}.weight_ih_l0{s}"] = _f32(w_ih[d].T)
        sd[f"{prefix}.weight_hh_l0{s}"] = _f32(w_hh[d].T)
        sd[f"{prefix}.bias_ih_l0{s}"] = _f32(bias[d])
        sd[f"{prefix}.bias_hh_l0{s}"] = np.zeros_like(_f32(bias[d]))


def _gate(sd, prefix: str, p) -> None:
    sd[f"{prefix}.0.weight"] = _f32(p["weight"]).reshape(-1, 1, 1, 1)
    sd[f"{prefix}.0.bias"] = _f32(p["bias"])
    sd[f"{prefix}.1.weight"] = _f32(p["act"]["alpha"]).reshape(1)


def tasnet_from_jax(params_np, module: str, layer: int, unfold: bool) -> Dict[str, np.ndarray]:
    """JAX TasNet params (DPRNN or DPTNet core, group_size 1) -> port TasNet
    ``state_dict`` (numpy): the inverse of the JAX package's
    ``utils/torch_import.py::convert_tasnet``."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    sd["encoder.weight"] = _f32(np.asarray(p["encoder"]["kernel"]).T[:, None, :])
    _norm(sd, "bottleneck.0", p["bn_norm"])
    sd["bottleneck.1.weight"] = _f32(np.asarray(p["bn_conv"]["kernel"]).T[:, :, None])
    core, pre = p["seq_model"], "seq_model.seq_model"
    names = [("_shared", 0)] if unfold else [(f"_{i}", i) for i in range(layer)]
    for jax_sfx, i in names:
        if module == "DPRNN":
            for side in ("row", "col"):
                rnn = core[f"{side}_rnn{jax_sfx}"]
                _lstm(sd, f"{pre}.{side}_rnn.{i}.rnn", rnn["rnn"])
                _dense(sd, f"{pre}.{side}_rnn.{i}.proj", rnn["proj"])
                _norm(sd, f"{pre}.{side}_norm.{i}", core[f"{side}_norm{jax_sfx}"])
        elif module == "DPTNet":
            for side in ("row", "col"):
                x = core[f"{side}_xfmr{jax_sfx}"]
                tp = f"{pre}.{side}_xfmr.{i}.transformer"
                sd[f"{tp}.self_attn.in_proj_weight"] = _f32(x["self_attn"]["in_proj_weight"])
                sd[f"{tp}.self_attn.in_proj_bias"] = _f32(x["self_attn"]["in_proj_bias"])
                _dense(sd, f"{tp}.self_attn.out_proj", x["self_attn"]["out_proj"])
                for n in ("norm1", "norm2"):
                    sd[f"{tp}.{n}.weight"] = _f32(x[n]["scale"])
                    sd[f"{tp}.{n}.bias"] = _f32(x[n]["bias"])
                _lstm(sd, f"{tp}.linear1", x["ffn_lstm"])
                _dense(sd, f"{tp}.linear2", x["ffn_proj"])
        else:
            raise NotImplementedError(f"no JAX converter for TasNet module {module!r}")
    if unfold:
        _gate(sd, f"{pre}.concat_block", core["concat_block"])
    sd[f"{pre}.output.weight"] = _f32(np.asarray(core["out_kernel"]).T[:, :, None, None])
    sd[f"{pre}.output.bias"] = _f32(core["out_bias"])
    _pointwise(sd, "mask.0", p["mask_conv"])
    sd["decoder.weight"] = _f32(np.asarray(p["decoder"]["kernel"])[:, None, :])
    return sd


def from_jax(model, params_np) -> Dict[str, np.ndarray]:
    """Convert a JAX tree for ``model`` (a port model instance)."""
    name = type(model).__name__
    if name == "ConvTasNet":
        return convtasnet_from_jax(params_np, model.R, model.X)
    if name == "TasNet":
        return tasnet_from_jax(params_np, model.module, model.layer, model.unfold)
    raise NotImplementedError(f"no JAX converter for {name}")
