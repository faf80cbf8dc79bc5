"""Process groups for data-parallel training (counterpart of
``audio_only_speech_separation_tpu/parallel/mesh.py`` and of the JAX
package's ``audio_train.maybe_init_distributed``).

The JAX package builds a 1-D mesh with axis ``dp`` over every device,
replicates the parameters and shards the batch, and XLA inserts the
gradient reduction.  Here the same layout is one process a card, launched
by ``torchrun``: ``init_distributed`` joins the process group that
torchrun's environment describes, each process loads its own shard of the
data (``shard_batch`` puts it on the process's device), and
``train.Trainer`` runs its train forward under ``DistributedDataParallel``,
whose backward averages the gradients over the ``dp`` group.  A second axis, ``sp`` (``make_mesh(axis_names=("dp",
"sp"), shape=(dp, sp))``), shares each sample's chunks among ``sp`` ranks
(``sequence.py``): the data are then sharded by the ``dp`` coordinate
(``dp_shard_info``), so the ranks of one ``sp`` group read the same batch.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def init_distributed(device="cuda", backend: str | None = None) -> tuple[int, int]:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without ``WORLD_SIZE`` and ``RANK`` it does nothing.
    On the card the process takes card ``LOCAL_RANK`` and the group NCCL;
    with ``device="cpu"`` gloo.  ``backend`` names another (gloo over CUDA
    tensors puts two ranks on one card, which NCCL refuses).  Joining the
    group and every collective wait at most 10 minutes for the other ranks.
    Returns ``local_shard_info()``."""
    env = os.environ
    if dist.is_initialized() or "WORLD_SIZE" not in env or "RANK" not in env:
        return local_shard_info()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass device=\"cpu\" for gloo on the CPU")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    address = f"tcp://{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=address,
                            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]),
                            timeout=timedelta(minutes=10))
    return local_shard_info()


def local_shard_info() -> tuple[int, int]:
    """(rank, world size): this process's shard of the data and the number
    of shards; (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(device="cuda", axis_names: Sequence[str] = ("dp",), shape: Sequence[int] | None = None):
    """A ``DeviceMesh`` over every rank of the process group: 1-D with axis
    ``dp`` (the JAX package's data-parallel mesh), or 2-D with axes ``("dp",
    "sp")`` and ``shape`` (dp, sp), whose product is the world size; rank r
    sits at (r // sp, r % sp), so an ``sp`` group is sp consecutive
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    axis_names = tuple(axis_names)
    world = local_shard_info()[1]
    if axis_names not in (("dp",), ("dp", "sp")):
        raise NotImplementedError(f"the mesh axes are ('dp',) or ('dp', 'sp'), not {axis_names}")
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} for axes {axis_names} does not cover the {world} ranks")
    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axis_names)


def dp_shard_info(sp: int = 1) -> tuple[int, int]:
    """(dp coordinate, dp size) of this rank on a (dp, ``sp``) mesh: the
    shard of the data it loads and the number of shards.  The ranks of one
    ``sp`` group load the same shard; ``local_shard_info()`` for sp 1."""
    rank, world = local_shard_info()
    if sp < 1 or world % sp:
        raise ValueError(f"sp {sp} does not divide the world size {world}")
    return rank // sp, world // sp


def local_mesh(device="cuda") -> torch.device:
    """The device this rank computes on: its card (the current CUDA device)
    or the CPU.  Evaluation stays on it, with no collective inside the
    loop, as the JAX package's ``local_mesh`` keeps it on the host's own
    devices."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_batch(batch: Any, mesh, axis: str = "dp"):
    """This rank's shard of a batch on this rank's device: every numpy
    array or tensor of a (possibly nested) tuple, list or dict, as tensors
    on ``local_mesh`` of ``mesh``'s device type (``mesh`` a ``DeviceMesh``
    with an ``axis`` axis, or a device).  Each rank loads its own shard of
    the data, so nothing is split or exchanged here: the JAX function's
    ``make_array_from_process_local_data`` for one process."""
    if isinstance(mesh, (torch.device, str)):
        dev = local_mesh(mesh)
    else:
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"shard_batch: the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
        dev = local_mesh(mesh.device_type)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(put(v) for v in x)
        return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(dev)

    return put(batch)


def replicate(module: nn.Module) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank (in place);
    nothing without a process group.  Returns ``module``."""
    if dist.is_initialized():
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, src=0)
    return module
