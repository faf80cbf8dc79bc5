"""Console output of rank 0 only (counterpart of
``audio_only_speech_separation_tpu/utils/console.py``; reference
look2hear/utils/lightning_utils.py:19-101, Lightning's ``@rank_zero_only``)."""

from __future__ import annotations

import torch.distributed as dist


def print_only(message: str) -> None:
    """Print ``message`` on rank 0 (every process without a process group)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(message, flush=True)
