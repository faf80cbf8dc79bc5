"""Resampling along one axis with torch's rules (counterpart of
``audio_only_speech_separation_tpu/ops/resample.py``): nearest
interpolation and adaptive average pooling for the multi-scale fusion of
TDANet and AFRCNN, ``avg_pool1d`` and linear interpolation with aligned
corners (``Upsample(mode='linear', align_corners=True)``) for Sandglasset's
pooling and upsampling.

All are built from index maps and matrices computed on the host from the
sizes alone, copied to each device once and kept: a copy from host memory
inside a forward would wait for the device's queue.  A matrix is rounded
to the activation's dtype, as the JAX package does, so a bf16 input stays
bf16.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=64)
def _nearest_idx_map(in_size: int, out_size: int) -> np.ndarray:
    """``F.interpolate(mode='nearest')``'s source index of every output
    position, bit for bit: ``min(floor(float32(dst) * float32(in/out)),
    in - 1)`` in float32 (an exact rational floor differs at some integer
    boundaries, e.g. 102 -> 810 at dst 405)."""
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale).astype(np.int64)
    return np.minimum(idx, in_size - 1)


@lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_nearest_idx_map(in_size, out_size)).to(device)


def interpolate_nearest(x: torch.Tensor, size: int, dim: int = -1) -> torch.Tensor:
    """torch 'nearest' resize of ``dim`` to ``size``; an integer upsampling
    whose index map is a plain repeat is a ``repeat_interleave``."""
    T = x.shape[dim]
    if size == T:
        return x
    idx = _nearest_idx_map(T, size)
    if size % T == 0 and np.array_equal(idx, np.arange(size) // (size // T)):
        return torch.repeat_interleave(x, size // T, dim=dim)
    return torch.index_select(x, dim, _nearest_index(T, size, x.device))


@lru_cache(maxsize=64)
def _pool_matrix(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[in, out] averaging matrix over torch's adaptive pooling windows
    [floor(i*in/out), ceil((i+1)*in/out)), in ``dtype`` on ``device``."""
    m = np.zeros((in_size, out_size), np.float32)
    for i in range(out_size):
        start, end = (i * in_size) // out_size, -(-((i + 1) * in_size) // out_size)
        m[start:end, i] = 1.0 / (end - start)
    return torch.from_numpy(m).to(device, dtype)


def adaptive_avg_pool1d(x: torch.Tensor, output_size: int, dim: int = -1) -> torch.Tensor:
    """``F.adaptive_avg_pool1d`` along ``dim``: an exact integer ratio is a
    reshape and mean, any other a product with the averaging matrix (in
    x's dtype)."""
    T = x.shape[dim]
    if output_size == T:
        return x
    dim = dim % x.ndim
    if T % output_size == 0:
        shape = x.shape[:dim] + (output_size, T // output_size) + x.shape[dim + 1:]
        return x.reshape(shape).mean(dim=dim + 1)
    out = torch.matmul(x.movedim(dim, -1), _pool_matrix(T, output_size, x.device, x.dtype))
    return out.movedim(-1, dim)


@lru_cache(maxsize=64)
def avg_pool_matrix(T: int, kernel: int, stride: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """[T, n] matrix of ``AvgPool1d(kernel, stride)``, n = (T - kernel)//stride
    + 1, in ``dtype`` on ``device``."""
    n = (T - kernel) // stride + 1
    m = np.zeros((T, n), np.float32)
    for i in range(n):
        m[i * stride: i * stride + kernel, i] = 1.0 / kernel
    return torch.from_numpy(m).to(device, dtype)


def _product_along(x: torch.Tensor, m: torch.Tensor, dim: int) -> torch.Tensor:
    """x times the [T, n] matrix ``m`` along ``dim`` (T there becomes n):
    on the last axis x @ m, elsewhere m^T @ x with ``dim`` second to last,
    which needs no copy of x where ``dim`` already is."""
    if dim == x.ndim - 1:
        return torch.matmul(x, m)
    return torch.matmul(m.t(), x.movedim(dim, -2)).movedim(-2, dim)


def avg_pool1d(x: torch.Tensor, kernel: int, stride: int | None = None, dim: int = -1) -> torch.Tensor:
    """``AvgPool1d(kernel, stride)`` along ``dim``, the tail that fills no
    window dropped: a reshape and mean of a view where stride == kernel,
    else a product with the averaging matrix in x's dtype."""
    stride = kernel if stride is None else stride
    dim = dim % x.ndim
    T = x.shape[dim]
    n = (T - kernel) // stride + 1
    if stride == kernel:
        windows = x.narrow(dim, 0, n * kernel)
        return windows.reshape(x.shape[:dim] + (n, kernel) + x.shape[dim + 1:]).mean(dim + 1)
    return _product_along(x, avg_pool_matrix(T, kernel, stride, x.device, x.dtype), dim)


@lru_cache(maxsize=64)
def _linear_interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float32 matrix of ``Upsample(mode='linear',
    align_corners=True)``: output j takes source position j*(in-1)/(out-1),
    split between its two neighbours."""
    m = np.zeros((in_size, out_size), dtype=np.float32)
    if in_size == 1:
        m[0, :] = 1.0
        return m
    for j in range(out_size):
        src = j * (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        frac = src - lo
        m[lo, j] += 1.0 - frac
        m[hi, j] += frac
    return m


@lru_cache(maxsize=64)
def linear_interp_matrix(in_size: int, out_size: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_linear_interp_matrix`` rounded to ``dtype`` on ``device``."""
    return torch.from_numpy(_linear_interp_matrix(in_size, out_size)).to(device, dtype)


def interpolate_linear_align_corners(x: torch.Tensor, size: int, dim: int = -1) -> torch.Tensor:
    """``dim`` of x from T to ``size``, linear with aligned corners, as a
    product with the interpolation matrix in x's dtype."""
    dim = dim % x.ndim
    T = x.shape[dim]
    if size == T:
        return x
    return _product_along(x, linear_interp_matrix(T, size, x.device, x.dtype), dim)
