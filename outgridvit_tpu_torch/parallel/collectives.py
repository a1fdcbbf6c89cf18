"""The collectives the port's parallel step runs, each an ``all_reduce``.

GSPMD inserts the collectives of the JAX step; the port names them here.
A gather writes a rank's rows (or its weight shard) into a zero-filled
buffer of the whole and sums the buffer over the group: exact, since
adding zeros changes no value (it turns a ``-0.0`` into ``+0.0``). Only
``all_reduce`` is used because gloo takes CUDA tensors only for
``all_reduce`` and ``broadcast``, and because an NCCL ``all_reduce`` can be
captured in a CUDA graph.

:class:`Axis` is one rank's view of one mesh axis: its process group (None
where no process group exists, a world of one without
``torch.distributed``: then every collective is the identity), the
group's size and the rank's index in it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen by one rank."""

    group: Optional[object]
    size: int
    index: int

    @property
    def active(self) -> bool:
        """A process group exists: the collectives run (a group of one
        included, where they return their input's values)."""
        return self.group is not None


NO_AXIS = Axis(None, 1, 0)


def all_reduce_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``x`` over the axis, in place; returns ``x``."""
    if axis.active:
        dist.all_reduce(x, group=axis.group)
    return x


def mean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The mean of ``x`` over the axis (a new tensor; ``x`` itself where no
    group exists)."""
    if not axis.active:
        return x
    out = all_reduce_(x.clone(), axis)
    return out / axis.size if axis.size > 1 else out


def gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The axis's pieces of a tensor split into equal blocks along ``dim``,
    in index order, whole on every rank (no gradient)."""
    if axis.size == 1:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * axis.size
    buf = x.new_zeros(shape)
    buf.narrow(dim, axis.index * n, n).copy_(x)
    return all_reduce_(buf, axis)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the axis; the backward sums the gradient over the axis:
    each rank's loss reaches every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Differentiable sum over the axis (SyncBatchNorm's statistics)."""
    if not axis.active:
        return x
    return _AllReduceSum.apply(x, axis)


class _GatherShard(torch.autograd.Function):
    """The whole weight from the axis's shards; the backward keeps the
    rank's slice of the whole weight's gradient, which every rank of the
    axis computes the same (they hold the same rows)."""

    @staticmethod
    def forward(ctx, shard, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, shard.shape[dim]
        return gather(shard, axis, dim)

    @staticmethod
    def backward(ctx, g):
        piece = g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n)
        return piece.contiguous(), None, None


def gather_shard(shard: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Differentiable whole weight of a tensor-parallel shard."""
    return _GatherShard.apply(shard, axis, dim)
