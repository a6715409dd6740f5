"""Collectives under autograd: the boundaries that ``shard_map`` draws
implicitly in the JAX package's expert-parallel MoE layer
(``models/moe.py::moe_ffn_ep``).

Inside ``shard_map`` a value replicated over the model axis that meets a
value that varies over it is broadcast (``pvary``), and the transpose of
that broadcast is a ``psum``; a ``psum`` of varying values is invariant,
and its transpose hands each shard the cotangent as it is.  Written as
plain ``all_reduce``s under autograd, each boundary needs its own backward:

* :func:`copy_to_group`: forward the identity, backward the sum of the
  cotangents over the group (a replicated input to per-shard work);
* :func:`reduce_from_group`: forward the sum over the group, backward the
  identity (per-shard partial results combined);
* :func:`mean_over_groups`: forward the mean over the batch axes' groups,
  backward the identity.  The step's gradient is the MEAN of the batch
  processes' gradients (``train/step.py``), and every process holds the
  same cotangent of the mean, so each one's share is that cotangent, not
  its ``1/n``th.

A group of ``None`` (a mesh axis of size 1) is the identity both ways, so
a (1, 1) mesh runs no collective.  Sums run in f32 and are cast back to
the tensor's dtype, so the backend needs no bf16 reduction.
:func:`gather_along` (no autograd) is the sharded decode step's exchange
of per-token results.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.to(torch.float32).contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOverGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, n):
        out = x.to(torch.float32).contiguous().clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        return (out / n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFromGroup.apply(x, group)


def mean_over_groups(x: torch.Tensor, groups: list, n: int) -> torch.Tensor:
    """``groups``: the batch axes' groups of size > 1; ``n`` the product of
    the batch axes' sizes."""
    return x if not groups else _MeanOverGroups.apply(x, groups, n)


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors ``t`` (one shape on every process) concatenated
    along ``dim`` in rank order; ``t`` itself for a group of None.  bf16
    travels as its 2-byte words, so the bits arrive as sent on any
    backend."""
    if group is None:
        return t
    wire = t.contiguous()
    if wire.dtype == torch.bfloat16:
        wire = wire.view(torch.int16)
    parts = [torch.empty_like(wire)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat([p.view(t.dtype) for p in parts], dim)
