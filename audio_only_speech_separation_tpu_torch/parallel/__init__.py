"""Data-parallel training across processes (counterpart of
``audio_only_speech_separation_tpu/parallel``; its ``sp`` axis,
``sequence.py``, is not ported)."""

from .mesh import init_distributed, local_mesh, local_shard_info, make_mesh, replicate

__all__ = [
    "init_distributed",
    "local_shard_info",
    "make_mesh",
    "local_mesh",
    "replicate",
]
