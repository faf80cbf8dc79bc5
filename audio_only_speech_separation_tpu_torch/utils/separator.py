"""Inference helpers (counterpart of ``audio_only_speech_separation_tpu/utils/separator.py``;
reference look2hear/utils/separator.py:24-72): ``separate`` a waveform and
``wav_file_separate`` a wav file into one file a speaker."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..data.audio_io import read_wav, write_wav
from ..models.base import eval_mode


class Separator:
    """The reference's interface of a separator (its ``forward_wav`` and
    ``sample_rate``), for subclasses."""

    def forward_wav(self, wav, **kwargs):
        raise NotImplementedError

    def sample_rate(self):
        raise NotImplementedError


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


def wav_file_separate(model, in_path: str, out_prefix: str, sample_rate=None) -> List[str]:
    """Separate the wav file ``in_path`` with ``separate`` on the model's
    device (the card unless the model was built on the CPU) and write
    ``<out_prefix>_s{i}.wav`` (PCM16 at ``sample_rate``, else the model's
    rate, else 16 kHz), one a speaker; returns their paths."""
    wav = read_wav(in_path)
    sr = sample_rate or getattr(model, "sample_rate", 16000)
    est = separate(model, wav[None])[0]
    paths = []
    for i in range(est.shape[0]):
        path = f"{out_prefix}_s{i + 1}.wav"
        write_wav(path, est[i], sr)
        paths.append(path)
    return paths
