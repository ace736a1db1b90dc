"""The collectives of the port's data and tensor parallelism.

This module imports nothing of the port, so that the ops can use it
without reaching the mesh and its model sharding.  Every function takes a
``torch.distributed`` process group, or None for one process, where it
returns its input: the same code path then serves both.

* ``copy_to_model`` and ``reduce_from_model`` are Megatron's *f* and *g*
  around a tensor-parallel block over the "model" group;
* ``all_reduce_sum`` sums the sync-BN moments over the "data" group, its
  gradient summed back;
* ``global_count`` sums a loss's denominator over "data";
* ``all_gather_rows`` joins per-row host results in rank order.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as tdist


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` in fp32 (gloo sums no bfloat16, and the
    partial sums of a row-parallel product keep their precision)."""
    if group is None:
        return t
    if t.dtype in (torch.float32, torch.float64, torch.int32, torch.int64):
        tdist.all_reduce(t, group=group)
        return t
    wide = t.float()
    tdist.all_reduce(wide, group=group)
    return t.copy_(wide)


def all_gather_rows(group, local: Sequence[Any]) -> List[Any]:
    """Every rank's list of host objects (per-row results), joined in rank
    order: the inverse of ``mesh.data_rows``."""
    if group is None:
        return list(local)
    parts: List[Any] = [None] * tdist.get_world_size(group)
    tdist.all_gather_object(parts, list(local), group=group)
    return [x for part in parts for x in part]


def global_count(count: torch.Tensor, group) -> torch.Tensor:
    """A batch-wide count (a loss's denominator) summed over the "data"
    group: each rank's loss is then its part of the global numerator over
    the global count, and the gradients summed over "data" are the global
    batch's.  No gradient flows through it."""
    if group is None:
        return count
    count = count.detach().clone()
    tdist.all_reduce(count, group=group)
    return count


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: the replicated input of a column-parallel block.
    Identity forward; the backward sums the shards' input gradients over
    "model"."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: the partial sums of a row-parallel product, summed
    over "model".  The backward is the identity: every model rank holds the
    same loss, so an all-reduce there (``torch.distributed.nn``'s) would
    make the gradients ``model`` times too large."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` whose gradient is summed over it too: the
    sync-BN moments, where each data rank's loss is a part of the global
    one and reaches every rank's statistics."""
    return x if group is None else _AllReduceSum.apply(x, group)
