"""Autograd boundaries of compute split over a mesh axis: where a value
held whole on every process of the axis meets per-process work, and where
per-process results leave it.

The JAX package draws these boundaries implicitly: GSPMD partitions the
transformer around its activation hints (``distrib/context.py``'s
``shard_hint``), and ``shard_map`` broadcasts and sums in the
expert-parallel MoE layer.  Written as plain collectives under autograd,
each boundary needs its own backward (the Megatron-LM pairs):

* :func:`copy_to_group` (copy-in): forward the identity, backward the sum
  of the cotangents over the group.  A value held whole that feeds
  per-process work (a column-split product, this process's experts, a
  norm weight applied to this process's heads) gets a part of its
  gradient on each process.
* :func:`reduce_from_group` (reduce-out): forward the sum over the group,
  backward the identity.  Per-process partial results (a row-split
  product, this process's experts' outputs) become the whole value, whose
  cotangent every process holds.
* :func:`gather_from_group` (gather-out): forward the group's parts
  concatenated along a dim, backward this process's slice of the
  cotangent.  A split value enters work that runs whole on every process.
* :func:`split_to_group` (split-in): forward this process's slice,
  backward the gather of the cotangents.  A value held whole enters work
  split along that dim.
* :func:`sum_scatter_to_group` (reduce-scatter): forward this process's
  slice of the sum over the group, backward the gather of the cotangents.
  Per-process partial results of which each process needs only its part
  (the RG-LRU gates' row-split products, whose scan runs on this
  process's channels) are summed for half the bytes of a reduce-out and
  a split-in.

Every sum runs in f32 in rank order (``collectives.all_sum``), so a step
repeats bit for bit and every process of the group gets the same bits.  A
group of ``None`` (a mesh axis of one process) is the identity both ways.
"""

from __future__ import annotations

import torch

from repro_torch.distrib.collectives import (all_sum, gather_along,
                                             group_rank, group_size,
                                             sum_scatter)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _own(x, group, dim: int) -> torch.Tensor:
    """This process's slice of ``x`` along ``dim`` (contiguous)."""
    n = x.shape[dim] // group_size(group)
    return x.narrow(dim, group_rank(group) * n, n).contiguous()


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_along(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim), None, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.group, ctx.dim), None, None


class _SumScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return sum_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_along(g, ctx.group, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _GatherFromGroup.apply(x, group, dim)


def split_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x``'s size along ``dim`` must divide by the group's."""
    return x if group is None else _SplitToGroup.apply(x, group, dim)


def sum_scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x``'s size along ``dim`` must divide by the group's."""
    return x if group is None else _SumScatterToGroup.apply(x, group, dim)
