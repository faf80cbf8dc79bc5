"""Learned-filterbank factory (counterpart of
``audio_only_speech_separation_tpu/layers/enc_dec.py``; reference
look2hear/layers/enc_dec.py).

``make_enc_dec`` builds a matched analysis/synthesis pair from a filterbank
family name; ``FreeFB`` is the fully learned filterbank.  Both run as
framed products over ``ops/conv.py``'s ``frame_signal`` and
``overlap_add``.  The filters keep torch's conv layout, [n_filters, 1,
kernel_size].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.conv import frame_signal, overlap_add


class Filterbank:
    """Config container: n_filters, kernel_size, stride (half the kernel
    by default)."""

    def __init__(self, n_filters: int, kernel_size: int, stride: Optional[int] = None):
        self.n_filters = n_filters
        self.kernel_size = kernel_size
        self.stride = stride if stride is not None else kernel_size // 2


class FreeFB(Filterbank):
    """Fully learned filterbank (reference enc_dec.py:349-441)."""


class Encoder(nn.Module):
    """Analysis: [B, T] (or [B, 1, T]) -> [B, n_filters, n_frames]."""

    def __init__(self, fb: Filterbank, device=None):
        super().__init__()
        self.fb = fb
        self.filters = nn.Parameter(torch.empty(fb.n_filters, 1, fb.kernel_size, device=device))
        nn.init.xavier_uniform_(self.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 3:
            x = x[:, 0]
        frames = frame_signal(x, self.fb.kernel_size, self.fb.stride)  # [B, n, k]
        return torch.matmul(frames, self.filters[:, 0].to(x.dtype).t()).transpose(1, 2)


class Decoder(nn.Module):
    """Synthesis: [B, n_filters, n_frames] -> [B, T] by overlap-add."""

    def __init__(self, fb: Filterbank, device=None):
        super().__init__()
        self.fb = fb
        self.filters = nn.Parameter(torch.empty(fb.n_filters, 1, fb.kernel_size, device=device))
        nn.init.xavier_uniform_(self.filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        frames = torch.matmul(x.transpose(1, 2), self.filters[:, 0].to(x.dtype))  # [B, n, k]
        return overlap_add(frames, self.fb.stride)


_FB_CLASSES = {"free": FreeFB}


def make_enc_dec(fb_name, n_filters: int, kernel_size: int, stride: Optional[int] = None,
                 device=None) -> Tuple[Encoder, Decoder]:
    """A matched encoder/decoder pair (reference enc_dec.py:16-79):
    ``fb_name`` a family name or a ``Filterbank`` class."""
    if isinstance(fb_name, str):
        if fb_name not in _FB_CLASSES:
            raise ValueError(f"Unknown filterbank {fb_name!r}; known: {sorted(_FB_CLASSES)}")
        fb_class = _FB_CLASSES[fb_name]
    else:
        fb_class = fb_name
    fb = fb_class(n_filters, kernel_size, stride)
    return Encoder(fb, device=device), Decoder(fb, device=device)
