"""The filterbank/STFT layer library (counterpart of
``audio_only_speech_separation_tpu/layers/stft_lib.py``; reference
look2hear/layers/stft.py): the window factory, the multi-mode DFT kernels,
the mel filterbank, the speed-perturbation resampling filter, feature
splicing, the functional ``forward_stft``/``inverse_stft`` and the
``STFT``/``iSTFT`` layer classes.

The factories are numpy, a copy of the JAX module's (the port imports
nothing of the JAX package).  The transforms frame the signal
(``Tensor.unfold``) and take one product of the frames [n_frames, W] with
the windowed kernel [2B, W] (``torch.matmul``, f32); the inverse is the
transposed product and ``ops/conv.py::overlap_add``, divided by the
overlapped squared window.  The "torch" mode is ``torch.fft.fft`` on the
torch-convention frames and the port's ``ops/stft.py::istft``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv import overlap_add
from ..ops.stft import istft as _istft

EPSILON = float(np.finfo(np.float32).eps)

__all__ = [
    "init_window",
    "init_kernel",
    "mel_filter",
    "speed_perturb_filter",
    "splice_feature",
    "forward_stft",
    "inverse_stft",
    "STFT",
    "iSTFT",
]


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def init_window(wnd: str, frame_len: int) -> np.ndarray:
    """Window coefficients, periodic (matching torch.*_window defaults and
    therefore librosa), except "rect".  Reference stft.py:31-57."""
    N = frame_len
    n = np.arange(N, dtype=np.float64)
    if wnd == "rect":
        w = np.ones(N)
    elif wnd in ("hann", "sqrthann"):
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / N)
        if wnd == "sqrthann":
            w = np.sqrt(w)
    elif wnd == "hamm":
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / N)
    elif wnd == "blackman":
        # torch.blackman_window(periodic=True) exact coefficients
        w = 0.42 - 0.5 * np.cos(2.0 * np.pi * n / N) + 0.08 * np.cos(
            4.0 * np.pi * n / N
        )
    elif wnd == "bartlett":
        # torch.bartlett_window(periodic=True): triangle over N+1 points,
        # last dropped
        w = 1.0 - np.abs(2.0 * n / N - 1.0)
    else:
        raise RuntimeError(f"Unknown window type: {wnd}")
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# DFT kernels
# ---------------------------------------------------------------------------

def init_kernel(
    frame_len: int,
    frame_hop: int,
    window: np.ndarray,
    round_pow_of_two: bool = True,
    normalized: bool = False,
    inverse: bool = False,
    mode: str = "librosa",
) -> Tuple[np.ndarray, np.ndarray]:
    """DFT kernel matrix [2B, W] + (possibly center-padded) window [W].

    Matches reference stft.py:61-113 semantics: fft_size B rounds up to a
    power of two under ``round_pow_of_two`` (always for kaldi); librosa mode
    center-pads the window to B and frames W = B samples, kaldi mode keeps
    W = frame_len and truncates the DFT matrix rows; ``normalized`` scales
    by B^-1/2, the inverse kernel by 1/B (so K^H K = I either way).

    The reference reshapes to [2B, 1, W] for conv1d; the framed product
    takes the plain [2B, W] matrix, which is what is returned.
    """
    if mode not in ("librosa", "kaldi"):
        raise ValueError(f"Unsupported mode: {mode}")
    if round_pow_of_two or mode == "kaldi":
        fft_size = 2 ** math.ceil(math.log2(frame_len))
    else:
        fft_size = frame_len
    window = np.asarray(window, np.float64)
    if mode == "librosa" and fft_size != frame_len:
        lpad = (fft_size - frame_len) // 2
        window = np.pad(window, (lpad, fft_size - frame_len - lpad))
    S = fft_size**0.5 if normalized else 1.0
    # K[w, k] = DFT of the w-th basis vector: exp(-2πi·w·k/B)
    K = np.fft.fft(np.eye(fft_size) / S, axis=-1)
    K = np.stack([K.real, K.imag], axis=-1)  # [W, B, 2]
    if mode == "kaldi":
        K = K[:frame_len]
    if inverse and not normalized:
        K = K / fft_size
    # [W, B, 2] → [2, B, W] → [2B, W]
    K = np.transpose(K, (2, 1, 0)).reshape(fft_size * 2, K.shape[0])
    return K.astype(np.float32), window.astype(np.float32)


# ---------------------------------------------------------------------------
# mel filterbank (librosa.filters.mel(htk=True) in numpy)
# ---------------------------------------------------------------------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filter(
    frame_len: int,
    round_pow_of_two: bool = True,
    num_bins: Optional[int] = None,
    sr: int = 16000,
    num_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    norm: bool = False,
) -> np.ndarray:
    """Mel filterbank [num_mels, N//2 + 1] — reference stft.py:116-162.

    HTK mel scale, triangle responses between band edges, optional Slaney
    area normalization (``norm=True``); the reference's fmax clamping
    quirks (negative fmax means "below Nyquist by that much") reproduced.
    """
    if num_bins is None:
        N = 2 ** math.ceil(math.log2(frame_len)) if round_pow_of_two else frame_len
    else:
        N = (num_bins - 1) * 2
    freq_upper = sr // 2
    if fmax is None:
        fmax = float(freq_upper)
    else:
        fmax = float(min(fmax + freq_upper if fmax < 0 else fmax, freq_upper))
    fmin = float(max(0.0, fmin))

    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + N // 2)
    mel_edges = _mel_to_hz_htk(
        np.linspace(_hz_to_mel_htk(fmin), _hz_to_mel_htk(fmax), num_mels + 2)
    )  # [num_mels + 2] band edge frequencies in Hz
    fdiff = np.diff(mel_edges)  # [num_mels + 1]
    ramps = mel_edges[:, None] - fft_freqs[None, :]  # [num_mels+2, F]
    lower = -ramps[:-2] / fdiff[:-1, None]  # rising edge of triangle m
    upper = ramps[2:] / fdiff[1:, None]  # falling edge
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm:  # Slaney: equal area per band
        enorm = 2.0 / (mel_edges[2 : num_mels + 2] - mel_edges[:num_mels])
        weights = weights * enorm[:, None]
    return weights.astype(np.float32)


# ---------------------------------------------------------------------------
# speed-perturbation resampling filter
# ---------------------------------------------------------------------------

def speed_perturb_filter(
    src_sr: int, dst_sr: int, cutoff_ratio: float = 0.95, num_zeros: int = 64
) -> np.ndarray:
    """Polyphase windowed-sinc resampler bank [dst_sr, src_sr, K] for
    src_sr → dst_sr speed perturbation.

    Same filter the reference vendors from danpovey/filtering
    (stft.py:163-193): a Hann-windowed sinc low-pass at ``cutoff_ratio``
    of the narrower Nyquist, evaluated at every (output-phase,
    input-phase) fractional lag.  Numerically identical weights
    ; the
    construction below is organized around the lag grid instead of the
    reference's flat index arithmetic.
    """
    if src_sr == dst_sr:
        raise ValueError(
            f"speed perturbation needs two distinct rates; got {src_sr} -> {dst_sr}"
        )
    g = math.gcd(src_sr, dst_sr)
    up, down = dst_sr // g, src_sr // g  # phases out / phases in
    if up == 1 or down == 1:
        raise ValueError(
            "integer-ratio resampling is outside the perturbation bank's domain"
        )
    # passband half-width (in input-sample units) and one-sided tap reach
    bw = cutoff_ratio * min(up, down)
    reach = 1 + int(num_zeros / bw)
    # lag[d, s] = position of output phase d/up relative to input phase
    # s/down; each tap k then sits at t = lag + (reach − k)
    lag = (
        np.arange(up, dtype=np.float64)[:, None] / up
        - np.arange(down, dtype=np.float64)[None, :] / down
    )
    t = lag[:, :, None] + (
        reach - np.arange(2 * reach + 1, dtype=np.float64)[None, None, :]
    )
    # raised-cosine window, open support (zero at |t| == reach)
    win = np.where(
        np.abs(t) < reach, 0.5 * (1.0 + np.cos(np.pi * t / reach)), 0.0
    )
    w = np.sinc(t * bw) * win * (bw / down)
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# feature splicing
# ---------------------------------------------------------------------------

def splice_feature(feats: torch.Tensor, lctx: int = 1, rctx: int = 1, op: str = "cat") -> torch.Tensor:
    """Splice [..., T, F] features with edge-clamped +-context frames
    (reference stft.py:196-223): ``cat`` -> [..., T, F*D]; ``stack`` ->
    [..., T, F, D] with D = lctx + rctx + 1."""
    if lctx + rctx == 0:
        return feats
    if op not in ("cat", "stack"):
        raise ValueError(f"Unknown op for feature splicing: {op}")
    T = feats.shape[-2]
    ctx = []
    for c in range(-lctx, rctx + 1):
        idx = torch.from_numpy(np.clip(np.arange(c, c + T), 0, T - 1)).to(feats.device)
        ctx.append(torch.index_select(feats, -2, idx))
    return torch.cat(ctx, -1) if op == "cat" else torch.stack(ctx, -1)


# ---------------------------------------------------------------------------
# functional STFT/iSTFT over the kernel matrices
# ---------------------------------------------------------------------------

def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


def _forward_stft_mat(wav: torch.Tensor, kernel: np.ndarray, window: np.ndarray, return_polar: bool = False,
                      pre_emphasis: float = 0.0, frame_hop: int = 256, onesided: bool = False,
                      center: bool = False, eps: float = EPSILON) -> torch.Tensor:
    """Framed-product STFT: N x (C) x S -> N x (C) x B(/2+1) x T x 2
    ([real; imag] or [mag; phase]); reference stft.py:226-289."""
    wav_dim = wav.ndim
    if wav_dim not in (2, 3):
        raise RuntimeError(f"STFT expect 2D/3D tensor, but got {wav_dim}D")
    N, S = wav.shape[0], wav.shape[-1]
    x = wav.reshape(-1, S).float()
    W = kernel.shape[-1]
    if center:
        x = _reflect_pad(x, W // 2)
    frames = x.unfold(-1, W, frame_hop)  # [NC, T, W]
    if pre_emphasis > 0:  # Kaldi pre-emphasis within each frame (reference stft.py:264-268)
        frames = torch.cat([frames[..., :1] * (1.0 - pre_emphasis),
                            frames[..., 1:] - pre_emphasis * frames[..., :-1]], dim=-1)
    kw = torch.from_numpy(kernel * window[None, :]).to(x.device)  # [2B, W]
    packed = torch.matmul(frames, kw.t()).transpose(1, 2)  # [NC, 2B, T]
    if wav_dim == 3:
        packed = packed.reshape(N, -1, packed.shape[-2], packed.shape[-1])
    real, imag = packed.chunk(2, dim=-2)
    if onesided:
        num_bins = kernel.shape[0] // 4 + 1
        real, imag = real[..., :num_bins, :], imag[..., :num_bins, :]
    return _pack(real, imag, return_polar, eps)


def _pack(real: torch.Tensor, imag: torch.Tensor, return_polar: bool, eps: float) -> torch.Tensor:
    if return_polar:
        return torch.stack([torch.sqrt(real ** 2 + imag ** 2 + eps), torch.atan2(imag, real)], dim=-1)
    return torch.stack([real, imag], dim=-1)


def _unpack(transform: torch.Tensor, return_polar: bool):
    """(real, imag) of a [N, F, T, 2] transform, a 3-D one taken as N = 1."""
    tdim = transform.ndim
    if tdim == 3:
        transform = transform[None]
    if transform.ndim != 4:
        raise RuntimeError(f"Expect 4D tensor, but got {tdim}D")
    if return_polar:
        return transform[..., 0] * torch.cos(transform[..., 1]), transform[..., 0] * torch.sin(transform[..., 1])
    return transform[..., 0], transform[..., 1]


def _inverse_stft_mat(transform: torch.Tensor, kernel: np.ndarray, window: np.ndarray,
                      return_polar: bool = False, frame_hop: int = 256, onesided: bool = False,
                      center: bool = False, eps: float = EPSILON) -> torch.Tensor:
    """Transposed product + overlap-add iSTFT with the window-square
    envelope normalisation; reference stft.py:291-358."""
    real, imag = _unpack(transform, return_polar)
    if onesided:  # rebuild the conjugate-symmetric upper bins [B/2-1 .. 1]
        rev = list(range(kernel.shape[0] // 4 - 1, 0, -1))
        real = torch.cat([real, real[:, rev]], 1)
        imag = torch.cat([imag, -imag[:, rev]], 1)
    packed = torch.cat([real, imag], dim=1).float()  # [N, 2B, T]
    kw = torch.from_numpy(kernel * window[None, :]).to(packed.device)  # [2B, W]
    frames = torch.matmul(packed.transpose(1, 2), kw)  # [N, T, W]
    wav = overlap_add(frames, frame_hop)  # [N, S]
    wsq = torch.from_numpy(window ** 2).to(packed.device)[None, None, :].expand(1, packed.shape[-1], -1)
    denorm = overlap_add(wsq, frame_hop)  # [1, S]
    if center:
        pad = kernel.shape[-1] // 2
        wav, denorm = wav[..., pad:-pad], denorm[..., pad:-pad]
    return wav / (denorm + eps)


def _fft_size(frame_len: int, round_pow_of_two: bool) -> int:
    return 2 ** math.ceil(math.log2(frame_len)) if round_pow_of_two else frame_len


def forward_stft(wav: torch.Tensor, frame_len: int, frame_hop: int, window: str = "sqrthann",
                 round_pow_of_two: bool = True, return_polar: bool = False, pre_emphasis: float = 0.0,
                 normalized: bool = False, onesided: bool = True, center: bool = False, mode: str = "librosa",
                 eps: float = EPSILON) -> torch.Tensor:
    """Functional STFT in the reference's three modes (stft.py:477-545):
    "librosa"/"kaldi" the framed product, "torch" the torch convention."""
    win = init_window(window, frame_len)
    if mode == "torch":
        return _torch_mode_stft(wav, frame_len, frame_hop, _fft_size(frame_len, round_pow_of_two), win,
                                return_polar, normalized, onesided, center, eps)
    kernel, win = init_kernel(frame_len, frame_hop, win, round_pow_of_two=round_pow_of_two,
                              normalized=normalized, inverse=False, mode=mode)
    return _forward_stft_mat(wav, kernel, win, return_polar=return_polar, pre_emphasis=pre_emphasis,
                             frame_hop=frame_hop, onesided=onesided, center=center, eps=eps)


def inverse_stft(transform: torch.Tensor, frame_len: int, frame_hop: int, return_polar: bool = False,
                 window: str = "sqrthann", round_pow_of_two: bool = True, normalized: bool = False,
                 onesided: bool = True, center: bool = False, mode: str = "librosa",
                 eps: float = EPSILON) -> torch.Tensor:
    """Functional iSTFT (reference stft.py:547-612)."""
    win = init_window(window, frame_len)
    if mode == "torch":
        return _torch_mode_istft(transform, frame_len, frame_hop, _fft_size(frame_len, round_pow_of_two), win,
                                 return_polar, normalized, onesided, center)
    kernel, win = init_kernel(frame_len, frame_hop, win, round_pow_of_two=round_pow_of_two,
                              normalized=normalized, inverse=True, mode=mode)
    return _inverse_stft_mat(transform, kernel, win, return_polar=return_polar, frame_hop=frame_hop,
                             onesided=onesided, center=center, eps=eps)


def _centred_window(win: np.ndarray, frame_len: int, n_fft: int) -> np.ndarray:
    """torch's padding of a win_length window to n_fft, centred."""
    if n_fft == frame_len:
        return win
    lpad = (n_fft - frame_len) // 2
    return np.pad(win, (lpad, n_fft - frame_len - lpad))


def _torch_mode_stft(wav, frame_len, frame_hop, n_fft, win, return_polar, normalized, onesided, center, eps):
    """torch.stft's convention: the window padded to n_fft, centred; the
    signal reflect-padded under ``center``; n_fft^-1/2 under
    ``normalized``."""
    wav_dim = wav.ndim
    if wav_dim not in (2, 3):
        raise RuntimeError(f"STFT expect 2D/3D tensor, but got {wav_dim}D")
    N = wav.shape[0]
    x = wav.reshape(-1, wav.shape[-1]).float()
    if center:
        x = _reflect_pad(x, n_fft // 2)
    w = torch.from_numpy(_centred_window(win, frame_len, n_fft)).to(x.device)
    spec = torch.fft.fft(x.unfold(-1, n_fft, frame_hop) * w, dim=-1)  # [NC, T, B]
    if normalized:
        spec = spec / (n_fft ** 0.5)
    if onesided:
        spec = spec[..., : n_fft // 2 + 1]
    real, imag = spec.real.transpose(-1, -2), spec.imag.transpose(-1, -2)  # [NC, F, T]
    if wav_dim == 3:
        real = real.reshape(N, -1, *real.shape[1:])
        imag = imag.reshape(N, -1, *imag.shape[1:])
    return _pack(real, imag, return_polar, eps)


def _torch_mode_istft(transform, frame_len, frame_hop, n_fft, win, return_polar, normalized, onesided, center):
    """torch.istft's convention (window-square normalisation), through
    ``ops/stft.py::istft``."""
    real, imag = _unpack(transform, return_polar)
    spec = torch.complex(real.float(), imag.float())  # [N, F, T]
    if normalized:
        spec = spec * (n_fft ** 0.5)
    if not onesided:
        spec = spec[:, : n_fft // 2 + 1]
    w = torch.from_numpy(_centred_window(win, frame_len, n_fft)).to(spec.device)
    return _istft(spec, n_fft, frame_hop, w, center=center, length=None)


# ---------------------------------------------------------------------------
# layer classes
# ---------------------------------------------------------------------------

class _STFTBase:
    """The kernel and window, computed once (reference STFTBase,
    stft.py:613-696): numpy constants with no parameters, as in the JAX
    package."""

    def __init__(self, frame_len: int, frame_hop: int, window: str = "sqrthann", round_pow_of_two: bool = True,
                 normalized: bool = False, pre_emphasis: float = 0.0, onesided: bool = True,
                 inverse: bool = False, center: bool = False, mode: str = "librosa") -> None:
        if mode != "torch":
            K, w = init_kernel(frame_len, frame_hop, init_window(window, frame_len),
                               round_pow_of_two=round_pow_of_two, normalized=normalized, inverse=inverse,
                               mode=mode)
            self.K, self.w = K, w
            self.num_bins = K.shape[0] // 4 + 1
            self.pre_emphasis = pre_emphasis
            self.win_length = K.shape[1]
        else:
            self.K = None
            self.w = init_window(window, frame_len)
            fft_size = _fft_size(frame_len, round_pow_of_two)
            self.num_bins = fft_size // 2 + 1
            self.pre_emphasis = 0.0
            self.win_length = fft_size
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.window = window
        self.normalized = normalized
        self.onesided = onesided
        self.center = center
        self.mode = mode

    def num_frames(self, wav_len):
        """Frame counts for signal lengths (reference stft.py:674-681)."""
        wav_len = np.asarray(wav_len)
        if not np.all(wav_len > self.win_length):
            raise ValueError(f"signal lengths {wav_len} must exceed the window length {self.win_length}")
        if self.center:
            wav_len = wav_len + self.win_length
        return (wav_len - self.win_length) // self.frame_hop + 1

    def extra_repr(self) -> str:
        s = (f"num_bins={self.num_bins}, win_length={self.win_length}, stride={self.frame_hop}, "
             f"window={self.window}, center={self.center}, mode={self.mode}")
        if not self.onesided:
            s += f", onesided={self.onesided}"
        if self.pre_emphasis > 0:
            s += f", pre_emphasis={self.pre_emphasis}"
        if self.normalized:
            s += f", normalized={self.normalized}"
        return s

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.extra_repr()})"


class STFT(_STFTBase):
    """STFT layer: N x (C) x S -> N x (C) x F x T x 2 (stft.py:699-738)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, inverse=False, **kwargs)

    def __call__(self, wav: torch.Tensor, return_polar: bool = False, eps: float = EPSILON) -> torch.Tensor:
        if self.mode == "torch":
            return _torch_mode_stft(wav, self.frame_len, self.frame_hop, (self.num_bins - 1) * 2, self.w,
                                    return_polar, self.normalized, self.onesided, self.center, eps)
        return _forward_stft_mat(wav, self.K, self.w, return_polar=return_polar, pre_emphasis=self.pre_emphasis,
                                 frame_hop=self.frame_hop, onesided=self.onesided, center=self.center, eps=eps)


class iSTFT(_STFTBase):
    """iSTFT layer: N x F x T x 2 -> N x S (stft.py:741-780)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, inverse=True, **kwargs)

    def __call__(self, transform: torch.Tensor, return_polar: bool = False, eps: float = EPSILON) -> torch.Tensor:
        if self.mode == "torch":
            return _torch_mode_istft(transform, self.frame_len, self.frame_hop, (self.num_bins - 1) * 2, self.w,
                                     return_polar, self.normalized, self.onesided, self.center)
        return _inverse_stft_mat(transform, self.K, self.w, return_polar=return_polar, frame_hop=self.frame_hop,
                                 onesided=self.onesided, center=self.center, eps=eps)
