"""Model shape contract, serialisation and pretrain loading (counterpart of
``audio_only_speech_separation_tpu/models/base.py``).

Every model maps waveforms [B, T] -> [B, n_src, T]; a 1-D input comes back
without the batch axis and [B, 1, T] is squeezed.  ``serialize`` writes the
same pickle layout as the JAX package, ``{model_name, state_dict,
model_args, infos}``, with the ``state_dict`` as numpy arrays under the
look2hear key names, so a checkpoint needs neither framework to unpickle.
"""

from __future__ import annotations

import contextlib
import inspect
import pickle
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


def normalize_input(wav: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """[T] | [B, T] | [B, 1, T] -> ([B, T], was_one_d)."""
    if wav.ndim == 1:
        return wav[None, :], True
    if wav.ndim == 3:
        return wav[:, 0, :], False
    return wav, False


def restore_output(out: torch.Tensor, was_one_d: bool) -> torch.Tensor:
    return out[0] if was_one_d else out


@contextlib.contextmanager
def eval_mode(model: nn.Module):
    """``model`` in eval mode inside the block (the JAX package's
    ``apply(..., train=False)``); on leaving it every submodule gets back
    its own ``training`` flag."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield model
    finally:
        for m, training in modes:
            m.training = training


_NOT_ARGS = ("self", "device", "generator")


def _arg_names(cls):
    return [k for k in inspect.signature(cls.__init__).parameters if k not in _NOT_ARGS]


class BaseModel(nn.Module):
    """Base for separation models: ``model_args`` are the constructor's
    keyword arguments (placement and seeding aside), which
    ``from_pretrain`` passes back."""

    def model_args(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in _arg_names(type(self))}


def serialize(model: BaseModel, state_dict=None) -> Dict[str, Any]:
    """Portable checkpoint dict (reference base_model.py:71-86) of ``model``,
    or of ``model``'s config with the weights ``state_dict`` (name -> numpy
    array or tensor) when given."""
    state = model.state_dict() if state_dict is None else state_dict
    return {
        "model_name": type(model).__name__,
        "state_dict": {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                       for k, v in state.items()},
        "model_args": model.model_args(),
        "infos": {
            "software_versions": {
                "torch_version": torch.__version__,
                "framework": "audio_only_speech_separation_tpu_torch",
            }
        },
    }


def save_serialized(conf: Dict[str, Any], path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(conf, f)


def _is_jax_tree(state: Dict[str, Any]) -> bool:
    return set(state) == {"params"} and isinstance(state["params"], dict)


def from_pretrain(pretrained_model_conf_or_path, device="cuda", **kwargs) -> BaseModel:
    """Rebuild a model with its weights from a serialised checkpoint, on
    ``device``: the CUDA card unless the caller asks for the CPU (raises
    when there is no card).

    Accepts a path or an already-loaded dict, written by this package or by
    the JAX package (whose ``state_dict`` is the nested ``{"params": ...}``
    tree; it is converted with ``utils.jax_import``).  Extra kwargs override
    the stored model args; args the model does not take are dropped."""
    from ..utils.jax_import import from_jax
    from . import get

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("from_pretrain: no CUDA device; pass device=\"cpu\" to load on the CPU")
    if isinstance(pretrained_model_conf_or_path, (str, bytes)):
        with open(pretrained_model_conf_or_path, "rb") as f:
            conf = pickle.load(f)
    else:
        conf = pretrained_model_conf_or_path
    model_class = get(conf["model_name"])
    args = dict(conf.get("model_args") or {})
    args.update(kwargs)
    valid = _arg_names(model_class)
    args = {k: v for k, v in args.items() if k in valid}
    model = model_class(**args, device=device)
    state = conf["state_dict"]
    if _is_jax_tree(state):
        state = from_jax(model, state)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state.items()})
    return model
