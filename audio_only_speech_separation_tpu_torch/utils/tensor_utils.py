"""Tensor helpers (counterpart of
``audio_only_speech_separation_tpu/utils/tensor_utils.py``; reference
look2hear/utils/torch_utils.py:12-49)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_x_to_y(x: torch.Tensor, y: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Right-pad with zeros (or crop) ``x`` along its last axis to ``y``'s
    length there."""
    if axis != -1:
        raise NotImplementedError
    inp_len, out_len = y.shape[-1], x.shape[-1]
    if out_len >= inp_len:
        return x[..., :inp_len]
    return F.pad(x, (0, inp_len - out_len))


def shape_reconstructed(reconstructed: torch.Tensor, size) -> torch.Tensor:
    """Drop the leading batch axis of a reconstruction whose input ``size``
    had none."""
    if len(size) == 1:
        return reconstructed.squeeze(0)
    return reconstructed


def tensors_to_device(tensors, device=None):
    """Move every tensor in a (nested) list, tuple or dict to ``device``;
    anything else is returned as it is."""
    if isinstance(tensors, torch.Tensor):
        return tensors.to(device)
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(tensors_to_device(t, device) for t in tensors)
    if isinstance(tensors, dict):
        return {k: tensors_to_device(v, device) for k, v in tensors.items()}
    return tensors
