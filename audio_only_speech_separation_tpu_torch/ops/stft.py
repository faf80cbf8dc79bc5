"""``torch.stft``/``torch.istft``-compatible STFT (counterpart of
``audio_only_speech_separation_tpu/ops/stft.py``): a periodic Hann window,
centred frames with reflect padding, a one-sided spectrum, and the inverse
with window-square overlap normalisation.

Framing and overlap-add are the port's own (``ops/conv.py``); the DFTs are
``torch.fft.rfft``/``irfft``.  ``stft_matmul`` is the same transform as a
framed product against cached cos/sin DFT matrices (f32), as the JAX
package computes it outside any kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch
import torch.nn.functional as F

from .conv import frame_signal, overlap_add


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann, ``torch.hann_window(win, periodic=True)``, computed in
    float64 and rounded once to ``dtype``."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)).to(dtype)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """x [B, T] -> complex spectrogram [B, n_fft // 2 + 1, n_frames]."""
    if center:
        p = n_fft // 2
        x = F.pad(x[:, None], (p, p), mode=pad_mode)[:, 0]
    frames = frame_signal(x, n_fft, hop_length) * window  # [B, n, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(1, 2)


@lru_cache(maxsize=8)
def _dft_matrices(n_fft: int, device: torch.device):
    """(cos, sin) [n_fft, n_fft // 2 + 1] f32 on ``device`` for the angles
    -2 pi k n / n_fft, built in float64 once a size and device (a copy from
    host memory inside a forward would wait for the device's queue)."""
    k = torch.arange(n_fft // 2 + 1, dtype=torch.float64)[None, :]
    n = torch.arange(n_fft, dtype=torch.float64)[:, None]
    ang = -2.0 * math.pi * k * n / n_fft
    return torch.cos(ang).float().to(device), torch.sin(ang).float().to(device)


def stft_matmul(x: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
                center: bool = True, pad_mode: str = "reflect"):
    """``stft`` as a framed product: x [B, T] -> (real, imag), each
    [B, n_fft // 2 + 1, n_frames] f32 (f32 products of the windowed frames
    with the DFT matrices)."""
    if center:
        p = n_fft // 2
        x = F.pad(x[:, None], (p, p), mode=pad_mode)[:, 0]
    frames = (frame_signal(x, n_fft, hop_length) * window).float()  # [B, n, n_fft]
    cos_m, sin_m = _dft_matrices(n_fft, frames.device)
    return (torch.matmul(frames, cos_m).transpose(1, 2), torch.matmul(frames, sin_m).transpose(1, 2))


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, window: torch.Tensor,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """Complex [B, F, n_frames] -> [B, T]: inverse DFT of each frame, the
    window, overlap-add, division by the overlapped squared window (clamped
    at 1e-11), and the centre padding cropped (to ``length`` if given)."""
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * window  # [B, n, n_fft]
    sig = overlap_add(frames, hop_length)
    wsq = window.square()[None, None, :].expand(1, frames.shape[1], n_fft)
    sig = sig / torch.clamp(overlap_add(wsq, hop_length)[0], min=1e-11)
    if center:
        p = n_fft // 2
        sig = sig[:, p:]
        return sig[:, :length] if length is not None else sig[:, : sig.shape[1] - p]
    return sig[:, :length] if length is not None else sig
