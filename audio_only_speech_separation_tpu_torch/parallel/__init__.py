"""Data-parallel and sequence-parallel training across processes
(counterpart of ``audio_only_speech_separation_tpu/parallel``): the ``dp``
axis (``mesh.py``) and the ``sp`` axis (``sequence.py``)."""

from .mesh import dp_shard_info, init_distributed, local_mesh, local_shard_info, make_mesh, replicate, shard_batch
from .sequence import (
    current_mesh_axes,
    exchange,
    gather,
    shard,
    shard_chunks,
    share_replicated,
    sp_group,
    use_mesh,
)

__all__ = [
    "init_distributed",
    "local_shard_info",
    "dp_shard_info",
    "make_mesh",
    "local_mesh",
    "replicate",
    "shard_batch",
    "current_mesh_axes",
    "use_mesh",
    "sp_group",
    "shard",
    "shard_chunks",
    "exchange",
    "gather",
    "share_replicated",
]
