"""Sequence (chunk-axis) parallelism, the ``sp`` mesh axis (counterpart of
``audio_only_speech_separation_tpu/parallel/sequence.py``).

The dual-path models cut their features into chunks, [B, N, K, S]: the
intra (row) pass runs over the K positions of each chunk, batched over the
S chunks, and the inter (column) pass over the S chunks, batched over the K
positions.  Under a mesh with an ``sp`` axis, the ranks of one ``sp``
group read the same batch and share each sample's work: the row pass runs
on this rank's share of S, the column pass on its share of K, with an
exchange between them, and a gather brings the whole tensor back before
the chunks are merged.  BSRNN does the same with its bands: the band RNNs
on a share of the bands, the band-communication RNN on a share of the
frames.

The JAX package marks the chunk axis for XLA's partitioner, which places
the collectives; here they are written out, with autograd:

- ``shard(x, dim)``: this rank's share of a replicated tensor (a slice);
  ``shard_chunks(x, chunk_axis)`` is the JAX package's name for it on the
  chunk axis;
- ``exchange(x, split_dim, cat_dim, cat_total)``: from sharded on
  ``cat_dim`` to sharded on ``split_dim``; its backward is the exchange
  back;
- ``gather(x, dim, total)``: the whole tensor from the shards; its backward
  sums the gradients of every rank's copy and keeps this rank's share (a
  reduce-scatter);
- ``ops.norms.global_moments(x, group)`` combines each rank's (count, mean,
  M2) with Chan's formula, so a gLN over a sharded sample normalises by the
  whole sample's moments.

All three are ``all_to_all_single`` over the ``sp`` group with uneven
splits: S follows the input length and K the chunk size, so neither need
divide by ``sp``, and the shares differ by at most one (the first ``n %
sp`` ranks take one more).  Nothing is padded, so the gLN statistics are
the whole sample's.  Gloo takes ``all_to_all_single`` on CUDA tensors (two
ranks on one card; checked on an H100), NCCL on any card.

Gradients: a rank's gradients are partial, and their sum over its ``sp``
group is the gradient of its ``dp`` shard's loss.  The sharded region's
parameters get their share from the collectives' backwards; the
replicated parts before and after it (the encoder, the mask, the decoder)
run on every rank of the group, so the train forward scales the gradient
of its replicated output by 1 / sp (``share_replicated``).  The trainer's
reduction then sums over ``sp`` and averages over ``dp``.

With no active mesh, or a mesh without ``sp`` (or with ``sp`` of size 1),
every function here is the identity, so single-card code is unchanged:
the JAX package's ``maybe_shard`` off a mesh.  ``use_mesh`` activates a
mesh for a block, the counterpart of ``jax.set_mesh``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist

_MESH = contextvars.ContextVar("sequence_parallel_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Inside the block ``mesh`` (a ``DeviceMesh``, or None) is the active
    mesh."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh_axes() -> tuple:
    """Axis names of the active mesh (empty if none)."""
    mesh = _MESH.get()
    return () if mesh is None else tuple(mesh.mesh_dim_names or ())


def sp_group():
    """The ``sp`` process group of this rank under the active mesh; None
    without a mesh, without an ``sp`` axis or with an ``sp`` axis of size 1."""
    mesh = _MESH.get()
    if mesh is None or "sp" not in current_mesh_axes() or mesh.size(current_mesh_axes().index("sp")) == 1:
        return None
    return mesh.get_group("sp")


def split_sizes(n: int, parts: int) -> list:
    """The shares of ``n`` items over ``parts`` ranks: the first ``n %
    parts`` take one more.  Raises if a share would be empty."""
    if n < parts:
        raise ValueError(f"sequence parallelism: {n} items cannot be shared by {parts} ranks")
    return [n // parts + (1 if r < n % parts else 0) for r in range(parts)]


def _all_to_all(sends, recv_shapes, group) -> list:
    """Send ``sends[j]`` to rank j of ``group``; returns the tensors of
    ``recv_shapes[j]`` received from each rank j (one
    ``all_to_all_single`` of the flattened pieces)."""
    send = torch.cat([t.reshape(-1) for t in sends])
    counts = [math.prod(s) for s in recv_shapes]
    recv = send.new_empty(sum(counts))
    dist.all_to_all_single(recv, send, output_split_sizes=counts,
                           input_split_sizes=[t.numel() for t in sends], group=group)
    return [piece.reshape(shape) for piece, shape in zip(recv.split(counts), recv_shapes)]


def _shape(shape, dim: int, size: int) -> tuple:
    """``shape`` with ``size`` at ``dim``."""
    shape = list(shape)
    shape[dim] = size
    return tuple(shape)


def shard(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's share of ``x`` along ``dim`` (``x`` is the same on every
    rank of the ``sp`` group); ``x`` itself off an ``sp`` mesh."""
    group = sp_group()
    if group is None:
        return x
    sizes = split_sizes(x.shape[dim], dist.get_world_size(group))
    rank = dist.get_rank(group)
    return x.narrow(dim, sum(sizes[:rank]), sizes[rank])


def shard_chunks(x: torch.Tensor, chunk_axis: int = -1, axis_name: str = "sp") -> torch.Tensor:
    """This rank's share of the chunk axis ``chunk_axis`` of a chunked
    feature tensor (dual-path layout [B, N, K, S]) through ``shard``; ``x``
    itself without an active mesh that has ``axis_name``.  The counterpart
    of the JAX function, which marks the axis for XLA's partitioner."""
    if axis_name not in current_mesh_axes():
        return x
    if axis_name != "sp":
        raise NotImplementedError(f"shard_chunks shares chunks over the 'sp' axis, not {axis_name!r}")
    return shard(x, chunk_axis % x.ndim)


def _exchange(x, split_dim: int, cat_dim: int, cat_total: int, group):
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    send = split_sizes(x.shape[split_dim], world)
    recv = split_sizes(cat_total, world)
    if x.shape[cat_dim] != recv[rank]:
        raise ValueError(f"exchange: axis {cat_dim} holds {x.shape[cat_dim]}, this rank's share of "
                         f"{cat_total} is {recv[rank]}")
    pieces = [p.contiguous() for p in x.split(send, dim=split_dim)]
    mine = _shape(x.shape, split_dim, send[rank])
    got = _all_to_all(pieces, [_shape(mine, cat_dim, n) for n in recv], group)
    return torch.cat(got, dim=cat_dim)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, cat_total, group):
        ctx.args = (split_dim, cat_dim, x.shape[split_dim], group)
        return _exchange(x, split_dim, cat_dim, cat_total, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, cat_dim, split_total, group = ctx.args
        return _exchange(grad, cat_dim, split_dim, split_total, group), None, None, None, None


def exchange(x: torch.Tensor, split_dim: int, cat_dim: int, cat_total: int) -> torch.Tensor:
    """``x`` sharded on ``cat_dim`` (whose whole length is ``cat_total``)
    and whole on ``split_dim`` -> sharded on ``split_dim`` and whole on
    ``cat_dim``; ``x`` itself off an ``sp`` mesh."""
    group = sp_group()
    if group is None:
        return x
    return _Exchange.apply(x, split_dim, cat_dim, cat_total, group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, total, group):
        world = dist.get_world_size(group)
        ctx.args = (dim, total, group)
        shapes = [_shape(x.shape, dim, n) for n in split_sizes(total, world)]
        return torch.cat(_all_to_all([x.contiguous()] * world, shapes, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        dim, total, group = ctx.args
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        sizes = split_sizes(total, world)
        pieces = [p.contiguous() for p in grad.split(sizes, dim=dim)]
        got = _all_to_all(pieces, [_shape(grad.shape, dim, sizes[rank])] * world, group)
        return torch.stack(got).sum(0), None, None, None


def gather(x: torch.Tensor, dim: int, total: int, group=None) -> torch.Tensor:
    """The whole tensor (``total`` long on ``dim``) from every rank's share
    ``x``; ``x`` itself off an ``sp`` mesh.  ``group`` defaults to the
    active mesh's ``sp`` group."""
    group = group if group is not None else sp_group()
    if group is None:
        return x
    return _Gather.apply(x, dim, total, group)


class _ShareReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def share_replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every rank of the ``sp`` group), with 1 / sp of
    its gradient on each rank, so that the group's gradients sum to the
    one process's; ``x`` itself off an ``sp`` mesh."""
    group = sp_group()
    if group is None:
        return x
    return _ShareReplicated.apply(x, 1.0 / dist.get_world_size(group))


def combine_moments(mean: torch.Tensor, var: torch.Tensor, count: int, group):
    """Per-sample moments of the whole sample from each rank's: ``mean``
    and ``var`` ([B, 1, ...], f32) over this rank's ``count`` elements of
    each sample.  Chan's formula over the ranks in order, so every rank of
    ``group`` gets the same moments; the variance stays clamped at 0."""
    B = mean.shape[0]
    n = torch.full((B,), float(count), dtype=torch.float32, device=mean.device)
    mine = torch.stack([n, mean.reshape(B), var.reshape(B) * count], dim=-1)  # [B, 3]
    world = dist.get_world_size(group)
    allr = gather(mine[None], 0, world, group)  # [sp, B, 3]
    ns, means, m2s = allr.unbind(-1)
    total = ns.sum(0)
    mu = (ns * means).sum(0) / total
    m2 = m2s.sum(0) + (ns * (means - mu).square()).sum(0)
    v = torch.clamp(m2 / total, min=0.0)
    return mu.reshape(mean.shape), v.reshape(var.shape)
