"""The calls every collective of the port's steps makes, and the bytes they
send.

Every exchange between the processes of a mesh axis goes through two calls
of ``torch.distributed``, on the tensors' bytes (gloo moves no int16, and
moves the card's tensors as they are): an ``all_gather``
(:func:`gather_parts`) and an ``all_to_all`` (:func:`exchange_parts`).  A
sum over the group (:func:`all_sum`) is a reduce-scatter and an
all-gather: the flat tensor is cut into one chunk per process, each
process receives the group's copies of its chunk, adds them in f32 in rank
order and casts the sum back, and the summed chunks are gathered.  Every
process of the group gets the same bits, on every run, whatever the
backend's own reduction order, and sends ``2 (n - 1) / n`` of the tensor,
as a ring all-reduce does; :func:`sum_scatter` stops after the
reduce-scatter, each process keeping its slice of the sum along a dim.  A
max (:func:`all_max`) gathers the parts.

:data:`traffic` counts the bytes that leave each process, per group (its
ranks) and kind (``"activation"``, or ``"parameter"`` where the sharded
step gathers a parameter): tests and ``chip_smoke.py`` read it to see what
a step moves over the model axis.  The calls go through a
:class:`Backend`; :func:`using` swaps it for the body of a ``with`` (the
dry run's counts on meta tensors, where no process stands behind a group).

The autograd boundaries of the expert-parallel MoE layer and of the
tensor-parallel transformer are ``distrib/tensor_parallel.py``; the batch
axes' mean is here:

* :func:`mean_over_groups`: forward the mean over the batch axes' groups,
  backward the identity.  The step's gradient is the MEAN of the batch
  processes' gradients (``train/step.py``), and every process holds the
  same cotangent of the mean, so each one's share is that cotangent, not
  its ``1/n``th.

A group of ``None`` (a mesh axis of size 1) is the identity.
"""

from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

F32 = torch.float32


class Backend:
    """The calls into ``torch.distributed`` that every collective here
    makes: a group's identity, size and this process's rank in it, and its
    two exchanges of byte tensors."""

    def key(self, group) -> tuple:
        return tuple(dist.get_process_group_ranks(group))

    def size(self, group) -> int:
        return dist.get_world_size(group)

    def rank(self, group) -> int:
        return dist.get_rank(group)

    def all_gather(self, parts: list, t: torch.Tensor, group) -> None:
        dist.all_gather(parts, t, group=group)

    def all_to_all(self, out: torch.Tensor, t: torch.Tensor, group) -> None:
        dist.all_to_all_single(out, t, group=group)


_backend = Backend()


@contextlib.contextmanager
def using(backend: Backend):
    """Route every collective through ``backend`` for the body of the
    ``with``."""
    global _backend
    prev, _backend = _backend, backend
    try:
        yield backend
    finally:
        _backend = prev


class Traffic:
    """Bytes sent per (group, kind) since the last :meth:`reset`."""

    def __init__(self):
        self.sent: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.sent.clear()

    def of(self, group, kind: str | None = None) -> int:
        """The bytes sent to ``group`` (its ``kind`` only, if given)."""
        key = group_key(group)
        return sum(n for (g, k), n in self.sent.items()
                   if g == key and kind in (None, k))


#: every process's counter (module state: one per process)
traffic = Traffic()


def group_key(group) -> tuple:
    return _backend.key(group)


def group_size(group) -> int:
    return _backend.size(group)


def group_rank(group) -> int:
    return _backend.rank(group)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes (every backend moves uint8, and copies them as sent)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def gather_parts(t: torch.Tensor, group, kind: str = "activation"
                 ) -> list[torch.Tensor]:
    """Every process's ``t`` (one shape everywhere) in rank order; counts
    the ``n - 1`` copies of ``t`` this process sends."""
    n = group_size(group)
    wire = _wire(t)
    traffic.sent[(group_key(group), kind)] += (n - 1) * wire.numel()
    parts = [torch.empty_like(wire) for _ in range(n)]
    _backend.all_gather(parts, wire, group)
    return [p.view(t.dtype).reshape(t.shape) for p in parts]


def exchange_parts(t: torch.Tensor, group, kind: str = "activation"
                   ) -> torch.Tensor:
    """``t`` [n, ...] (one shape everywhere): row ``r`` goes to the process
    of rank ``r``, and row ``r`` of the result is what the process of rank
    ``r`` sent here; counts the ``n - 1`` rows sent to the others."""
    n = group_size(group)
    wire = _wire(t)
    traffic.sent[(group_key(group), kind)] += wire.numel() // n * (n - 1)
    out = torch.empty_like(wire)
    _backend.all_to_all(out, wire, group)
    return out.view(t.dtype).reshape(t.shape)


def all_sum(t: torch.Tensor, group, kind: str = "activation") -> torch.Tensor:
    """The sum of the group's ``t``, added in f32 in rank order and cast
    back to ``t``'s dtype: the same bits on every process (a reduce-scatter
    of its chunks, then an all-gather)."""
    if group is None:
        return t
    n = group_size(group)
    flat = t.reshape(-1)
    chunk = -(-flat.numel() // n)
    if chunk * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(chunk * n - flat.numel())])
    mine = exchange_parts(flat.reshape(n, chunk), group, kind)
    acc = mine[0].to(F32)
    for r in range(1, n):
        acc = acc + mine[r].to(F32)
    out = torch.cat(gather_parts(acc.to(t.dtype), group, kind))
    return out[:t.numel()].reshape(t.shape)


def sum_scatter(t: torch.Tensor, group, dim: int,
                kind: str = "activation") -> torch.Tensor:
    """This process's slice along ``dim`` of the group's ``t`` summed: the
    first half of :func:`all_sum` with the chunks cut along ``dim`` (each
    process receives the group's copies of its slice and adds them in f32
    in rank order), so its bits are those of ``all_sum`` sliced, for half
    the bytes.  ``t``'s size along ``dim`` must divide by the group's."""
    if group is None:
        return t
    n = group_size(group)
    rows = t.movedim(dim, 0)
    part = (rows.shape[0] // n, *rows.shape[1:])
    mine = exchange_parts(rows.reshape(n, -1), group, kind)
    acc = mine[0].to(F32)
    for r in range(1, n):
        acc = acc + mine[r].to(F32)
    return acc.to(t.dtype).reshape(part).movedim(0, dim).contiguous()


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of the group's ``t``."""
    if group is None:
        return t
    return torch.stack(gather_parts(t, group)).amax(0)


def gather_along(t: torch.Tensor, group, dim: int,
                 kind: str = "activation") -> torch.Tensor:
    """The group's tensors ``t`` (one shape on every process) concatenated
    along ``dim`` in rank order; ``t`` itself for a group of None.  The
    bits arrive as sent on any backend."""
    if group is None:
        return t
    return torch.cat(gather_parts(t, group, kind), dim)


class _MeanOverGroups(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, n):
        out = x.to(F32)
        for g in groups:
            out = all_sum(out, g)
        return (out / n).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def mean_over_groups(x: torch.Tensor, groups: list, n: int) -> torch.Tensor:
    """``groups``: the batch axes' groups of size > 1; ``n`` the product of
    the batch axes' sizes."""
    return x if not groups else _MeanOverGroups.apply(x, groups, n)
