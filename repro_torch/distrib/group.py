"""Host-object collectives through which rank 0 of a process group drives
the checkpoint engine for every process.

The engine (``TensorCheckpoint``, ``AsyncCheckpointer``, the store) is a
bulk-synchronous simulation over per-rank lists and its store has one
writer, so one process runs it: the others hand their host blocks to rank
0 (``gather_to_root``) and receive theirs back (``root_call`` with
``scatter``).  Every call that runs engine code on rank 0 broadcasts its
outcome, so when rank 0 fails every process raises at once instead of
waiting at its next collective.  Objects travel through the CPU backend
(gloo) also where the tensors' backend is NCCL.
"""

from __future__ import annotations

from typing import Any, Callable

import torch.distributed as dist


class PeerFailed(RuntimeError):
    """Raised on every process when the group's rank 0 failed a call that
    all of them were waiting on."""


def active(group=None) -> bool:
    """True when a process group is initialised (``group`` or the default)."""
    return group is not None or (dist.is_available() and dist.is_initialized())


def rank(group=None) -> int:
    return dist.get_rank(group) if active(group) else 0


def world(group=None) -> int:
    return dist.get_world_size(group) if active(group) else 1


def _root(group) -> int:
    """The global rank of ``group``'s rank 0."""
    return 0 if group is None else dist.get_global_rank(group, 0)


def gather_to_root(obj: Any, group=None) -> list | None:
    """Every process's ``obj``, in rank order, on rank 0; None elsewhere."""
    if not active(group):
        return [obj]
    out = [None] * world(group) if rank(group) == 0 else None
    dist.gather_object(obj, out, dst=_root(group), group=group)
    return out


def root_call(fn: Callable[[], Any], group=None, *, scatter: bool = False):
    """Run ``fn`` on rank 0 and hand its outcome to every process.

    Rank 0's value is broadcast (``scatter=False``) or, when ``fn`` returns
    one value per rank, each process receives its own (``scatter=True``).
    If ``fn`` raises (a ``BaseException`` too: a simulated process death),
    rank 0 re-raises it and every other process raises ``PeerFailed``.
    Without a process group, ``fn`` just runs here."""
    if not active(group):
        value = fn()
        return value[0] if scatter else value
    me, n = rank(group), world(group)
    err: BaseException | None = None
    if me == 0:
        try:
            value = fn()
            if scatter and len(value) != n:
                raise ValueError(f"root_call: {len(value)} values for "
                                 f"{n} ranks")
            msgs = ([("ok", v) for v in value] if scatter
                    else [("ok", value)])
        except BaseException as e:      # noqa: BLE001 — re-raised below
            err = e
            why = f"{type(e).__name__}: {e}"
            if e.__cause__ is not None:
                why += f" (from {type(e.__cause__).__name__}: {e.__cause__})"
            msgs = [("error", why)] * (n if scatter else 1)
    else:
        msgs = [None] * (n if scatter else 1)
    if scatter:
        got = [None]
        dist.scatter_object_list(got, msgs if me == 0 else None,
                                 src=_root(group), group=group)
    else:
        got = msgs
        dist.broadcast_object_list(got, src=_root(group), group=group)
    status, value = got[0]
    if err is not None:
        raise err
    if status == "error":
        raise PeerFailed(f"rank 0 failed: {value}")
    return value
