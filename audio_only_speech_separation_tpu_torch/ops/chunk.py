"""50%-overlap segmentation and overlap-add merge on [B, C, T] features
(counterpart of ``audio_only_speech_separation_tpu/ops/chunk.py``;
reference look2hear/models/utils/gc3_basics.py:63-109).

- ``pad_segment``: right-pad so (stride + T) is a multiple of block_size,
  then pad ``block_size // 2`` zeros on both ends.
- ``split_feature``: two half-shifted segmentations interleaved ->
  [B, C, block_size, n_chunks] (chunk index last).
- ``merge_feature``: the overlap-add inverse, dropping the padding.

merge(split(x)) == 2 * x: every sample lies in exactly two chunks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_segment(x: torch.Tensor, block_size: int):
    """x [B, C, T] -> (padded [B, C, T'], rest)."""
    T = x.shape[-1]
    stride = block_size // 2
    rest = block_size - (stride + T % block_size) % block_size
    if rest > 0:
        x = F.pad(x, (0, rest))
    return F.pad(x, (stride, stride)), rest


def split_feature(x: torch.Tensor, block_size: int):
    """x [B, C, T] -> (chunks [B, C, block_size, n_chunks], rest)."""
    x, rest = pad_segment(x, block_size)
    B, C, T = x.shape
    stride = block_size // 2
    b1 = x[:, :, : T - stride].reshape(B, C, -1, block_size)
    b2 = x[:, :, stride:].reshape(B, C, -1, block_size)
    blocks = torch.stack([b1, b2], dim=3).reshape(B, C, -1, block_size)  # b1_0, b2_0, b1_1, ...
    return blocks.transpose(2, 3), rest


def merge_feature(x: torch.Tensor, rest: int) -> torch.Tensor:
    """x [B, C, block_size, n_chunks] -> overlap-added [B, C, T]."""
    B, C, block_size, _ = x.shape
    stride = block_size // 2
    x = x.transpose(2, 3).reshape(B, C, -1, block_size * 2)  # [B, C, n/2, 2K]
    part1 = x[:, :, :, :block_size].reshape(B, C, -1)[:, :, stride:]
    part2 = x[:, :, :, block_size:].reshape(B, C, -1)[:, :, :-stride]
    out = part1 + part2
    return out[:, :, :-rest] if rest > 0 else out
