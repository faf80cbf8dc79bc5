"""Inference helper (counterpart of ``audio_only_speech_separation_tpu/utils/separator.py``;
reference look2hear/utils/separator.py:24-72)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.base import eval_mode


def separate(model, wav):
    """wav: numpy or tensor [T] | [B, T] -> separated sources, same kind.

    Runs ``model`` on its own device in eval mode (the JAX package's
    ``apply`` defaults to ``train=False``; the module's own mode is restored
    afterwards) and applies the reference's energy renormalisation over the
    whole array (out *= sum|in| / sum|out|, separator.py:59-60)."""
    is_numpy = isinstance(wav, np.ndarray)
    device = next(model.parameters()).device
    x = torch.as_tensor(wav, device=device)
    with torch.no_grad(), eval_mode(model):
        out = model(x)
        out = out * (x.abs().sum() / out.abs().sum())
    return out.cpu().numpy() if is_numpy else out
