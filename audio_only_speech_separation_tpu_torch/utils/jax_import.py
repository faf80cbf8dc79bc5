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
- Sepformer's ``conv2d_kernel`` [N, N*spks] -> Conv2d weight [N*spks, N, 1, 1]
- dual-path gate weight [C] -> Conv2d weight [C, 1, 1, 1]; core
  ``out_kernel`` [in, out] -> Conv2d weight [out, in, 1, 1]
- Sandglasset's ``first_out_kernel`` [N, M] -> Conv2d weight [M, N, 1, 1]
  and ``decoder_kernel`` [N, win] -> ``decoder.basis_lin.weight`` [win, N]
- TAC's three Dense layers -> look2hear's ``TAC_{input,mean,output}.0``
- the layer library (``layers_from_jax``): flax conv kernels [k, in/groups,
  out] -> Conv1d weight [out, in/groups, k]; flax BatchNorm ``scale``,
  ``bias`` and its ``batch_stats`` ``mean``, ``var`` -> ``weight``, ``bias``,
  ``running_mean``, ``running_var``; filterbank filters [k, N] / [N, k] ->
  [N, 1, k]; the DPRNN head's ``out_kernel`` [N, M] -> Conv2d weight
  [M, N, 1, 1]
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


def _layer_norm(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _f32(p["scale"])
    sd[f"{prefix}.bias"] = _f32(p["bias"])


def _mha(sd, prefix: str, p) -> None:
    sd[f"{prefix}.in_proj_weight"] = _f32(p["in_proj_weight"])
    sd[f"{prefix}.in_proj_bias"] = _f32(p["in_proj_bias"])
    _dense(sd, f"{prefix}.out_proj", p["out_proj"])


def _gate(sd, prefix: str, p, conv_dims: int = 2) -> None:
    sd[f"{prefix}.0.weight"] = _f32(p["weight"]).reshape((-1, 1) + (1,) * conv_dims)
    sd[f"{prefix}.0.bias"] = _f32(p["bias"])
    sd[f"{prefix}.1.weight"] = _f32(p["act"]["alpha"]).reshape(1)


def _prelu(sd, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _f32(p["alpha"]).reshape(1)


def _tac(sd, prefix: str, p) -> None:
    """JAX ``TAC`` -> look2hear's ``TAC_{input,mean,output}.{0,1}``, ``TAC_norm``."""
    for port, dense, act in (("TAC_input", "transform", "act_in"), ("TAC_mean", "average", "act_mean"),
                             ("TAC_output", "concat", "act_out")):
        _dense(sd, f"{prefix}.{port}.0", p[dense])
        _prelu(sd, f"{prefix}.{port}.1", p[act])
    _norm(sd, f"{prefix}.TAC_norm", p["norm"])


def _proj_rnn(sd, prefix: str, p) -> None:
    _lstm(sd, f"{prefix}.rnn", p["rnn"])
    _dense(sd, f"{prefix}.proj", p["proj"])


def _gc_rnn(sd, prefix: str, p, num_layers: int = 2) -> None:
    for i in range(num_layers):
        _tac(sd, f"{prefix}.TAC.{i}", p[f"tac_{i}"])
        _proj_rnn(sd, f"{prefix}.rnn.{i}", p[f"rnn_{i}"])
        _norm(sd, f"{prefix}.LN.{i}", p[f"norm_{i}"])


def _uconv_block(sd, prefix: str, p, depth: int = 5) -> None:
    _conv_norm(sd, f"{prefix}.proj_1x1", p["proj_1x1"])
    for k in range(depth):
        _conv_norm(sd, f"{prefix}.spp_dw.{k}", p[f"spp_{k}"])
    _norm(sd, f"{prefix}.final_norm.norm", p["final_norm"])
    _prelu(sd, f"{prefix}.final_norm.act", p["final_act"])
    _pointwise(sd, f"{prefix}.res_conv", p["res_conv"])


def _tcn(sd, pre: str, core, n_blocks: int, grouped: bool) -> None:
    """A JAX ``TCN`` (or ``GC_TCN``) of ``n_blocks`` blocks under ``pre``."""
    if grouped:
        _pointwise(sd, f"{pre}.output", core["out_conv"])
    else:
        _norm(sd, f"{pre}.LN", core["LN"])
        _pointwise(sd, f"{pre}.BN", core["BN"])
        _prelu(sd, f"{pre}.output.0", core["out_act"])
        _pointwise(sd, f"{pre}.output.1", core["out_conv"])
    for i in range(n_blocks):
        if grouped:
            _tac(sd, f"{pre}.TAC.{i}", core[f"tac_{i}"])
        blk, bp = core[f"block_{i}"], f"{pre}.TCN.{i}"
        for name in ("conv1d", "res_out", "skip_out"):
            _pointwise(sd, f"{bp}.{name}", blk[name])
        _conv1d(sd, f"{bp}.dconv1d", blk["dconv1d"])
        _prelu(sd, f"{bp}.nonlinearity1", blk["act1"])
        _prelu(sd, f"{bp}.nonlinearity2", blk["act2"])
        _norm(sd, f"{bp}.reg1", blk["reg1"])
        _norm(sd, f"{bp}.reg2", blk["reg2"])


def tasnet_from_jax(params_np, module: str, layer: int, unfold: bool,
                    group_size: int = 1) -> Dict[str, np.ndarray]:
    """JAX TasNet params (any separator module and group size) -> port
    TasNet ``state_dict`` (numpy): the inverse of the JAX package's
    ``utils/torch_import.py::convert_tasnet``."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    sd["encoder.weight"] = _f32(np.asarray(p["encoder"]["kernel"]).T[:, None, :])
    _norm(sd, "bottleneck.0", p["bn_norm"])
    sd["bottleneck.1.weight"] = _f32(np.asarray(p["bn_conv"]["kernel"]).T[:, :, None])
    if group_size > 1:
        _gc_rnn(sd, "context_enc", p["context_enc"])
        _gc_rnn(sd, "context_dec", p["context_dec"])
    if module in ("DPRNN", "DPTNet"):
        core, pre = p["seq_model"], "seq_model.seq_model"
        if group_size > 1:
            for i in range(layer):
                _tac(sd, f"{pre}.TAC.{i}", core[f"tac_{i}"])
        names = [("_shared", 0)] if unfold else [(f"_{i}", i) for i in range(layer)]
        for jax_sfx, i in names:
            for side in ("row", "col"):
                if module == "DPRNN":
                    _proj_rnn(sd, f"{pre}.{side}_rnn.{i}", core[f"{side}_rnn{jax_sfx}"])
                    _norm(sd, f"{pre}.{side}_norm.{i}", core[f"{side}_norm{jax_sfx}"])
                    continue
                x = core[f"{side}_xfmr{jax_sfx}"]
                tp = f"{pre}.{side}_xfmr.{i}.transformer"
                _mha(sd, f"{tp}.self_attn", x["self_attn"])
                for n in ("norm1", "norm2"):
                    _layer_norm(sd, f"{tp}.{n}", x[n])
                _lstm(sd, f"{tp}.linear1", x["ffn_lstm"])
                _dense(sd, f"{tp}.linear2", x["ffn_proj"])
        if unfold:
            _gate(sd, f"{pre}.concat_block", core["concat_block"])
        sd[f"{pre}.output.weight"] = _f32(np.asarray(core["out_kernel"]).T[:, :, None, None])
        sd[f"{pre}.output.bias"] = _f32(core["out_bias"])
    elif module in ("TCN", "GC_TCN"):
        _tcn(sd, "seq_model.tcn", p["seq_model"], 2 * layer, module == "GC_TCN")  # stack 2
    elif module in ("SudoRMRF", "GC_SudoRMRF"):
        for i in range(layer):
            blk, pre = p[f"seq_model_{i}"], f"seq_model.sudo_rmrf_layers.{i}"
            if module == "GC_SudoRMRF":
                _tac(sd, f"{pre}.TAC", blk["tac"])
                _uconv_block(sd, f"{pre}.UBlock", blk["ublock"])
            else:
                _uconv_block(sd, pre, blk)
    else:
        raise NotImplementedError(f"no JAX converter for TasNet module {module!r}")
    _pointwise(sd, "mask.0", p["mask_conv"])
    sd["decoder.weight"] = _f32(np.asarray(p["decoder"]["kernel"])[:, None, :])
    return sd


def sepformer_from_jax(params_np, masknet_numlayers: int, intra_numlayers: int,
                       inter_numlayers: int) -> Dict[str, np.ndarray]:
    """JAX Sepformer params -> port Sepformer ``state_dict`` (numpy): the
    inverse of the JAX package's ``utils/torch_import.py::convert_sepformer``."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    sd["encoder.conv1d.weight"] = _f32(np.asarray(p["encoder"]["kernel"]).T[:, None, :])
    _norm(sd, "masknet.norm", p["mask_norm"])
    sd["masknet.conv1d.weight"] = _f32(np.asarray(p["mask_conv1d"]["kernel"]).T[:, :, None])
    for i in range(masknet_numlayers):
        blk = p[f"dual_mdl_{i}"]
        for side, n_layers in (("intra", intra_numlayers), ("inter", inter_numlayers)):
            mdl, pre = blk[f"{side}_mdl"], f"masknet.dual_mdl.{i}.{side}_mdl.mdl"
            for j in range(n_layers):
                layer, lp = mdl[f"layer_{j}"], f"{pre}.layers.{j}"
                _mha(sd, f"{lp}.self_att.att", layer["self_att"])
                _layer_norm(sd, f"{lp}.norm1", layer["norm1"])
                _layer_norm(sd, f"{lp}.norm2", layer["norm2"])
                _dense(sd, f"{lp}.pos_ffn.ffn.0", layer["ffn1"])
                _dense(sd, f"{lp}.pos_ffn.ffn.3", layer["ffn2"])
            _layer_norm(sd, f"{pre}.norm", mdl["norm"])
            _norm(sd, f"masknet.dual_mdl.{i}.{side}_norm", blk[f"{side}_norm"])
    sd["masknet.prelu.weight"] = _f32(p["mask_prelu"]["alpha"]).reshape(1)
    sd["masknet.conv2d.weight"] = _f32(np.asarray(p["conv2d_kernel"]).T[:, :, None, None])
    sd["masknet.conv2d.bias"] = _f32(p["conv2d_bias"])
    _pointwise(sd, "masknet.output.0", p["output"])
    _pointwise(sd, "masknet.output_gate.0", p["output_gate"])
    sd["masknet.end_conv1x1.weight"] = _f32(np.asarray(p["end_conv1x1"]["kernel"]).T[:, :, None])
    sd["decoder.weight"] = _f32(np.asarray(p["decoder"]["kernel"])[:, None, :])
    return sd


def bsrnn_from_jax(params_np, nband: int, num_repeat: int, num_layer: int,
                   bi_comm: bool) -> Dict[str, np.ndarray]:
    """JAX BSRNN params -> port BSRNN ``state_dict`` (numpy): the inverse of
    the JAX package's ``utils/torch_import.py::convert_bsrnn``."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    for i in range(nband):
        _norm(sd, f"BN.{i}.0", p[f"bn_norm_{i}"])
        _pointwise(sd, f"BN.{i}.1", p[f"bn_conv_{i}"])
    for r in range(num_repeat):
        sep = p[f"separator_{r}"]
        for name in [f"band_rnn.{j}" for j in range(num_layer)] + ["band_comm"]:
            res, pre = sep[name.replace(".", "_")], f"separator.{r}.{name}"
            _norm(sd, f"{pre}.norm", res["norm"])
            _lstm(sd, f"{pre}.rnn", res["rnn"])
            _dense(sd, f"{pre}.proj", res["proj"])
    for i in range(nband):
        _norm(sd, f"mask.{i}.0", p[f"mask_norm_{i}"])
        for c, j in ((1, 1), (2, 3), (3, 5), (4, 7)):
            _pointwise(sd, f"mask.{i}.{j}", p[f"mask_c{c}_{i}"])
        sd[f"mask.{i}.6.weight"] = _f32(p[f"mask_act_{i}"]["alpha"]).reshape(1)
    return sd


def _conv1d(sd, prefix: str, p) -> None:
    """flax Conv {Conv_0: {kernel [k, in/groups, out], bias}} -> Conv1d weight
    [out, in/groups, k] (and bias)."""
    sd[f"{prefix}.weight"] = _f32(np.transpose(np.asarray(p["Conv_0"]["kernel"]), (2, 1, 0)))
    if "bias" in p["Conv_0"]:
        sd[f"{prefix}.bias"] = _f32(p["Conv_0"]["bias"])


def _conv_norm(sd, prefix: str, p) -> None:
    """ConvNorm / DilatedConvNorm / ConvNormAct: {conv, norm[, act]}."""
    _conv1d(sd, f"{prefix}.conv", p["conv"])
    _norm(sd, f"{prefix}.norm", p["norm"])
    if "act" in p:
        sd[f"{prefix}.act.weight"] = _f32(p["act"]["alpha"]).reshape(1)


def _filterbank_shell(sd, p, sm_gates) -> None:
    """The encoder, gLN, bottleneck, mask head, decoder and the separator's
    re-injection gates ``sm_gates`` [(port prefix, JAX name)] of TDANet and
    AFRCNN."""
    _conv1d(sd, "encoder", p["encoder"])
    _norm(sd, "ln", p["ln"])
    _pointwise(sd, "bottleneck", p["bottleneck"])
    sd["mask_net.0.weight"] = _f32(p["mask_act"]["alpha"]).reshape(1)
    _pointwise(sd, "mask_net.1", p["mask_conv"])
    sd["decoder.weight"] = _f32(p["decoder"]["kernel"])
    C = sd["bottleneck.bias"].shape[0]
    for prefix, name in sm_gates:
        # a one-iteration model never applies its gate, so the JAX package
        # never builds it: the identity scale and torch's slope stand in
        gate = p["sm"].get(name) or {"weight": np.ones(C), "bias": np.zeros(C),
                                     "act": {"alpha": np.full(1, 0.25)}}
        _gate(sd, prefix, gate, conv_dims=1)


def tdanet_from_jax(params_np, upsampling_depth: int, num_blocks: int,
                    unfold: bool = True) -> Dict[str, np.ndarray]:
    """JAX TDANet params -> port TDANet ``state_dict`` (numpy): the inverse
    of the JAX package's ``utils/torch_import.py::convert_tdanet`` (which
    covers ``unfold``); without ``unfold`` the JAX ``unet_{i}`` and
    ``concat_block_{i}`` become ``sm.unet.{i}`` and ``sm.concat_block.{i}``."""
    p = params_np["params"] if "params" in params_np else params_np
    D = upsampling_depth
    sd: Dict[str, np.ndarray] = {}
    if unfold:
        units, gates = [("sm.unet", "unet")], [("sm.concat_block", "concat_block")]
    else:
        units = [(f"sm.unet.{i}", f"unet_{i}") for i in range(num_blocks)]
        gates = [(f"sm.concat_block.{i}", f"concat_block_{i}") for i in range(num_blocks - 1)]
    _filterbank_shell(sd, p, gates)
    for pre, name in units:
        u = p["sm"][name]
        _conv_norm(sd, f"{pre}.proj_1x1", u["proj_1x1"])
        for k in range(D):
            _conv_norm(sd, f"{pre}.spp_dw.{k}", u[f"spp_{k}"])
        for i in range(D):
            for branch in ("local_embedding", "global_embedding", "global_act"):
                _conv_norm(sd, f"{pre}.loc_glo_fus.{i}.{branch}", u[f"fus_{i}"][branch])
                if i < D - 1:
                    _conv_norm(sd, f"{pre}.last_layer.{i}.{branch}", u[f"last_{i}"][branch])
        att, mlp = u["globalatt"]["attn"], u["globalatt"]["mlp"]
        _layer_norm(sd, f"{pre}.globalatt.attn.attn_in_norm", att["attn_in_norm"])
        _mha(sd, f"{pre}.globalatt.attn.attn", att["attn"])
        _layer_norm(sd, f"{pre}.globalatt.attn.norm", att["norm"])
        _conv_norm(sd, f"{pre}.globalatt.mlp.fc1", mlp["fc1"])
        _conv1d(sd, f"{pre}.globalatt.mlp.dwconv", mlp["dwconv"])
        _conv_norm(sd, f"{pre}.globalatt.mlp.fc2", mlp["fc2"])
        _pointwise(sd, f"{pre}.res_conv", u["res_conv"])
    return sd


def afrcnn_from_jax(params_np, upsampling_depth: int) -> Dict[str, np.ndarray]:
    """JAX AFRCNN params -> port AFRCNN ``state_dict`` (numpy): the inverse
    of the JAX package's ``utils/torch_import.py::convert_afrcnn``."""
    p = params_np["params"] if "params" in params_np else params_np
    D = upsampling_depth
    sd: Dict[str, np.ndarray] = {}
    _filterbank_shell(sd, p, [("sm.concat_block", "concat_block")])
    b, pre = p["sm"]["blocks"], "sm.blocks"
    _conv_norm(sd, f"{pre}.proj_1x1", b["proj_1x1"])
    for i in range(D):
        _conv_norm(sd, f"{pre}.spp_dw.{i}", b[f"spp_{i}"])
        _conv_norm(sd, f"{pre}.concat_layer.{i}", b[f"concat_{i}"])
        if i > 0:
            _conv_norm(sd, f"{pre}.fuse_layers.{i}.0", b[f"down_{i}"])
    _conv_norm(sd, f"{pre}.last_layer.0", b["last_layer"])
    _pointwise(sd, f"{pre}.res_conv", b["res_conv"])
    return sd


def dprnn_tasnet_from_jax(params_np, layer: int) -> Dict[str, np.ndarray]:
    """JAX DPRNNTasNet params -> port DPRNNTasNet ``state_dict`` (numpy): the
    inverse of the JAX package's ``utils/torch_import.py::convert_dprnn_tasnet``
    (cLN norms, as ``OldDPRNN(full_causal=True)`` has, included)."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    sd["encoder._filters"] = _f32(np.asarray(p["encoder"]["kernel"]).T[:, None, :])
    _norm(sd, "freq_norm", p["freq_norm"])
    sd["freq_separator.BN.weight"] = _f32(np.asarray(p["BN"]["kernel"]).T[:, :, None])
    sd.update({f"freq_separator.DPRNN.{k}": v for k, v in old_dprnn_from_jax(p["DPRNN"], layer).items()})
    sd["decoder._filters"] = _f32(np.asarray(p["decoder"]["kernel"])[:, None, :])
    return sd


def single_rnn_proj_from_jax(params_np) -> Dict[str, np.ndarray]:
    """A JAX ``SingleRNNProj``'s params -> the port's
    ``models/dprnn_old.py::SingleRNNProj`` ``state_dict``."""
    sd: Dict[str, np.ndarray] = {}
    _proj_rnn(sd, "", params_np["params"] if "params" in params_np else params_np)
    return {k[1:]: v for k, v in sd.items()}


def old_dprnn_from_jax(core, layer: int) -> Dict[str, np.ndarray]:
    """A JAX ``OldDPRNN``'s params -> the port core's ``state_dict``."""
    core = core["params"] if "params" in core else core
    sd: Dict[str, np.ndarray] = {}
    for i in range(layer):
        for side in ("row", "col"):
            sd.update({f"{side}_rnn.{i}.{k}": v
                       for k, v in single_rnn_proj_from_jax(core[f"{side}_rnn_{i}"]).items()})
            _norm(sd, f"{side}_norm.{i}", core[f"{side}_norm_{i}"])
    sd["output.weight"] = _f32(np.asarray(core["out_kernel"]).T[:, :, None, None])
    sd["output.bias"] = _f32(core["out_bias"])
    return sd


def sandglasset_block_from_jax(blk) -> Dict[str, np.ndarray]:
    """A JAX ``SandglassetBlock``'s params -> the port block's ``state_dict``."""
    blk = blk["params"] if "params" in blk else blk
    sd: Dict[str, np.ndarray] = {}
    _lstm(sd, "intra_RNN.rnn", blk["intra_rnn"])
    _dense(sd, "intra_linear", blk["intra_linear"])
    _norm(sd, "intra_norm", blk["intra_norm"])
    _layer_norm(sd, "inter_RNN.attn_in_norm", blk["attn_in_norm"])
    _mha(sd, "inter_RNN.attn_layer.0.attn", blk["attn_layer"]["attn"])
    _layer_norm(sd, "inter_RNN.attn_layer.0.norm", blk["attn_layer"]["norm"])
    _norm(sd, "inter_norm", blk["inter_norm"])
    return sd


def sandglasset_from_jax(params_np, n_repeats: int) -> Dict[str, np.ndarray]:
    """JAX Sandglasset params -> port Sandglasset ``state_dict`` (numpy): the
    inverse of the JAX package's ``utils/torch_import.py::convert_sandglasset``."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, np.ndarray] = {}
    sd["encoder.weight"] = _f32(np.asarray(p["encoder"]["kernel"]).T[:, None, :])
    _norm(sd, "enc_LN", p["enc_LN"])
    sd["bottleneck.weight"] = _f32(np.asarray(p["bottleneck"]["kernel"]).T[:, :, None])
    _norm(sd, "seg_norm", p["seg_norm"])
    for i in range(n_repeats):
        sd.update({f"sep_net.{i}.{k}": v for k, v in sandglasset_block_from_jax(p[f"sep_{i}"]).items()})
    sd["first_out.0.weight"] = _f32(p["first_out_act"]["alpha"]).reshape(1)
    sd["first_out.1.weight"] = _f32(np.asarray(p["first_out_kernel"]).T[:, :, None, None])
    sd["first_out.1.bias"] = _f32(p["first_out_bias"])
    _norm(sd, "out_norm", p["out_norm"])
    sd["decoder.basis_lin.weight"] = _f32(np.asarray(p["decoder_kernel"]).T)
    return sd


def from_jax(model, params_np) -> Dict[str, np.ndarray]:
    """Convert a JAX tree for ``model`` (a port model instance)."""
    name = type(model).__name__
    if name == "ConvTasNet":
        return convtasnet_from_jax(params_np, model.R, model.X)
    if name == "TasNet":
        return tasnet_from_jax(params_np, model.module, model.layer, model.unfold, model.group_size)
    if name == "Sepformer":
        return sepformer_from_jax(params_np, model.masknet_numlayers, model.intra_numlayers,
                                  model.inter_numlayers)
    if name == "BSRNN":
        return bsrnn_from_jax(params_np, model.nband, model.num_repeat, model.num_layer, model.bi_comm)
    if name == "TDANet":
        return tdanet_from_jax(params_np, model.upsampling_depth, model.num_blocks, model.unfold)
    if name == "AFRCNN":
        return afrcnn_from_jax(params_np, model.upsampling_depth)
    if name == "DPRNNTasNet":
        return dprnn_tasnet_from_jax(params_np, model.layer)
    if name == "Sandglasset":
        return sandglasset_from_jax(params_np, model.n_repeats)
    raise NotImplementedError(f"no JAX converter for {name}")


# ---------------------------------------------------------------------------
# the layer library (``layers/``): one converter a port class, by name
# ---------------------------------------------------------------------------

def _ln_any(sd, prefix, m, p, s) -> None:
    """gLN, cLN and LN (their affine pair), or BatchNorm with its running
    statistics from the ``batch_stats`` collection."""
    if type(m).__name__ != "BatchNorm1d":
        _norm(sd, prefix, p)
        return
    bn, st = p["BatchNorm_0"], s["BatchNorm_0"]
    sd[f"{prefix}.weight"] = _f32(bn["scale"])
    sd[f"{prefix}.bias"] = _f32(bn["bias"])
    sd[f"{prefix}.running_mean"] = _f32(st["mean"])
    sd[f"{prefix}.running_var"] = _f32(st["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _conv_norm_layer(sd, prefix, m, p, s) -> None:
    _conv1d(sd, f"{prefix}.conv", p["conv"])
    _norm(sd, f"{prefix}.norm", p["norm"])
    if "act" in p:
        _prelu(sd, f"{prefix}.act", p["act"])


def _conv1d_block(sd, prefix, m, p, s) -> None:
    for name in ("in_conv", "res_conv", "skip_conv"):
        _pointwise(sd, f"{prefix}.{name}", p[name])
    _conv1d(sd, f"{prefix}.dconv", p["dconv"])
    for name in ("act1", "act2"):
        _prelu(sd, f"{prefix}.{name}", p[name])
    for name in ("norm1", "norm2"):
        _ln_any(sd, f"{prefix}.{name}", getattr(m, name), p[name], s.get(name, {}))


def _frcnn_block(sd, prefix, m, p, s) -> None:
    D = m.depth
    _conv_norm_layer(sd, f"{prefix}.proj", None, p["proj"], {})
    for k in range(D):
        _conv_norm_layer(sd, f"{prefix}.down.{k}", None, p[f"down_{k}"], {})
        _conv_norm_layer(sd, f"{prefix}.concat.{k}", None, p[f"concat_{k}"], {})
        if k > 0:
            _conv_norm_layer(sd, f"{prefix}.fuse_down.{k - 1}", None, p[f"fuse_down_{k}"], {})
    _conv_norm_layer(sd, f"{prefix}.last", None, p["last"], {})
    _pointwise(sd, f"{prefix}.res_conv", p["res_conv"])


def _rnn_layer(sd, prefix, m, p, s) -> None:
    _lstm(sd, f"{prefix}.rnn", p["rnn"])
    if "proj" in p:  # LSTMBlockTF
        _dense(sd, f"{prefix}.proj", p["proj"])
        _layer_norm(sd, f"{prefix}.norm", p["norm"])


def _transformer_block(sd, prefix, m, p, s) -> None:
    _mha(sd, f"{prefix}.attn", p["attn"])
    for name in ("norm1", "norm2"):
        _layer_norm(sd, f"{prefix}.{name}", p[name])
    for name in ("ffn1", "ffn2"):
        _dense(sd, f"{prefix}.{name}", p[name])


def _dual_path_block(sd, prefix, m, p, s) -> None:
    """DPRNNBlock and DPRNNLinear."""
    _lstm(sd, f"{prefix}.row_rnn", p["row_rnn"])
    _dense(sd, f"{prefix}.row_proj", p["row_proj"])
    _norm(sd, f"{prefix}.row_norm", p["row_norm"])
    if "col_linear" in p:
        _dense(sd, f"{prefix}.col_linear", p["col_linear"])
    else:
        _lstm(sd, f"{prefix}.col_rnn", p["col_rnn"])
        _dense(sd, f"{prefix}.col_proj", p["col_proj"])
    _norm(sd, f"{prefix}.col_norm", p["col_norm"])


def _dprnn(sd, prefix, m, p, s) -> None:
    for i in range(len(m.blocks)):
        _dual_path_block(sd, f"{prefix}.blocks.{i}", None, p[f"block_{i}"], {})
    if m.output is not None:
        sd[f"{prefix}.output.weight"] = _f32(np.asarray(p["out_kernel"]).T[:, :, None, None])


def _video_conv(sd, prefix, m, p, s) -> None:
    if not m.first_block:
        _ln_any(sd, f"{prefix}.bn", m.bn, p["bn"], s["bn"])
    _conv1d(sd, f"{prefix}.dconv", p["dconv"])
    name = "sconv" if m.skip_con else "bconv"
    _pointwise(sd, f"{prefix}.{name}", p[name])


def _concat(sd, prefix, m, p, s) -> None:
    _pointwise(sd, f"{prefix}.proj", p["proj"])
    _prelu(sd, f"{prefix}.act", p["act"])


def _bottomup(sd, prefix, m, p, s) -> None:
    _conv_norm_layer(sd, f"{prefix}.proj_1x1", None, p["proj_1x1"], {})
    for k in range(len(m.spp)):
        _conv_norm_layer(sd, f"{prefix}.spp.{k}", None, p[f"spp_{k}"], {})


def _bottomup_topdown(sd, prefix, m, p, s) -> None:
    _bottomup(sd, f"{prefix}.bottomup", m.bottomup, p["bottomup"], {})
    _norm(sd, f"{prefix}.fuse_norm", p["fuse_norm"])
    _pointwise(sd, f"{prefix}.res_conv", p["res_conv"])


def _relative_mha(sd, prefix, m, p, s) -> None:
    for name in ("query_proj", "key_proj", "value_proj", "pos_proj", "out_proj"):
        _dense(sd, f"{prefix}.{name}", p[name])
    sd[f"{prefix}.u_bias"] = _f32(p["u_bias"])
    sd[f"{prefix}.v_bias"] = _f32(p["v_bias"])


def _mhsa_module(sd, prefix, m, p, s) -> None:
    _layer_norm(sd, f"{prefix}.norm", p["norm"])
    _relative_mha(sd, f"{prefix}.attn", None, p["attn"], {})


def _conformer_conv(sd, prefix, m, p, s) -> None:
    _layer_norm(sd, f"{prefix}.norm", p["norm"])
    _pointwise(sd, f"{prefix}.pw1", p["pw1"])
    _conv1d(sd, f"{prefix}.dw", p["dw"])
    _norm(sd, f"{prefix}.bn", p["bn"])
    _pointwise(sd, f"{prefix}.pw2", p["pw2"])


def _filters(transpose: bool):
    def convert(sd, prefix, m, p, s) -> None:
        f = np.asarray(p["filters"])
        sd[f"{prefix}.filters"] = _f32((f.T if transpose else f)[:, None, :])
    return convert


_LAYERS = {
    "GlobalLayerNorm": _ln_any, "CumulativeLayerNorm": _ln_any, "FrameLayerNorm": _ln_any,
    "BatchNorm1d": _ln_any,
    "PReLU": lambda sd, prefix, m, p, s: _prelu(sd, prefix, p),
    "MultiheadAttention": lambda sd, prefix, m, p, s: _mha(sd, prefix, p),
    "PositionalEncoding": lambda sd, prefix, m, p, s: None,  # no parameters
    "TAC": lambda sd, prefix, m, p, s: _tac(sd, prefix, p),
    "Encoder": _filters(True), "Decoder": _filters(False),
    "ConvNorm": _conv_norm_layer, "ConvNormAct": _conv_norm_layer, "Conv1DBlock": _conv1d_block,
    "FRCNNBlock": _frcnn_block, "SingleRNN": _rnn_layer, "LSTMBlockTF": _rnn_layer,
    "TransformerBlockTF": _transformer_block, "DPRNNBlock": _dual_path_block, "DPRNNLinear": _dual_path_block,
    "DPRNN": _dprnn, "Video1DConv": _video_conv, "Concat": _concat, "Bottomup": _bottomup,
    "BottomupConcatTopdown": _bottomup_topdown, "RelativeMultiHeadAttention": _relative_mha,
    "MultiHeadedSelfAttentionModule": _mhsa_module, "ConformerConvModule": _conformer_conv,
}


def layers_from_jax(module, jax_variables) -> Dict[str, np.ndarray]:
    """A JAX layer's variables (``{"params": ..., "batch_stats": ...}`` as
    numpy, or the params tree alone) -> the ``state_dict`` (numpy) of
    ``module``, the port's counterpart of that layer (``layers/``)."""
    name = type(module).__name__
    if name not in _LAYERS:
        raise NotImplementedError(f"no JAX converter for layer {name}")
    v = jax_variables
    p = v["params"] if "params" in v else v
    sd: Dict[str, np.ndarray] = {}
    _LAYERS[name](sd, "", module, p, v.get("batch_stats", {}))
    return {k[1:]: a for k, a in sd.items()}  # drop the empty prefix's "."
