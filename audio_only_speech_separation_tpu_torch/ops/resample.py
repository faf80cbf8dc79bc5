"""Nearest interpolation and adaptive average pooling along one axis, with
torch's rules (counterpart of ``audio_only_speech_separation_tpu/ops/resample.py``),
for the multi-scale fusion of TDANet and AFRCNN.

Both are built from index maps and pooling matrices computed on the host
from the sizes alone, copied to each device once and kept: a copy from
host memory inside a forward would wait for the device's queue.
``avg_pool1d`` and the linear interpolation of the JAX package are still
to port: no model of the port calls them.
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
