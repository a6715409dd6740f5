"""Step-time mesh context, the counterpart of the JAX package's
``distrib/context.py``.

Every step builder (``train/step.py``: the train step, on one device or
sharded, and the prefill and decode steps) installs a :class:`MeshContext`
for the duration of a step, as the reference's builders do, and model code
reads it through :func:`mesh_context`: the MoE layer
(``models/transformer.py::_ffn``) runs the expert-parallel
``moe_ffn_ep`` over the context's mesh when its config asks for it, and
the decode paths read how the sharded decode step splits each cache entry
(:func:`cache_split`).  With none installed the models run their
mesh-free paths, as in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class DimSplit:
    """One dim of a serving-cache entry split over a mesh axis of more
    than one process: this process holds ``[start, stop)`` of the dim's
    ``size`` entries, and ``group`` is the axis's process group (ranks in
    coordinate order)."""
    start: int
    stop: int
    size: int
    group: object


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object          # torch DeviceMesh, or {axis: 1} for one device
    dp_axes: tuple[str, ...] = ("data",)     # batch-parallel mesh axes
    ep_axis: str = "model"                   # expert-parallel mesh axis
    rules: object = None                     # RuleTable for activation hints
    # the sharded decode step's cache: {entry: {dim: DimSplit}} for every
    # dim but the batch one that a mesh axis of several processes splits
    cache_splits: dict | None = None

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)


def shard_hint(x, logical_axes: tuple[str | None, ...]):
    """Activation placement by LOGICAL axis names.

    The reference constrains an activation's sharding here and returns the
    same values; GSPMD then partitions the compute around it.  The port's
    sharded step gathers the parameters and runs the whole step on every
    process (``train/step.py``; only the MoE layer's experts are split over
    the model axis, by ``moe_ffn_ep`` itself), so no activation is sharded
    and the hint returns ``x`` as it is: the values are the reference's
    either way."""
    return x


def mesh_context() -> MeshContext | None:
    return getattr(_STATE, "ctx", None)


def cache_split(entry: str, dim: int) -> DimSplit | None:
    """How the installed context's decode step splits dim ``dim`` of cache
    entry ``entry`` (dims of the whole entry, its layer dim 0 included);
    None where this process holds the dim whole."""
    ctx = mesh_context()
    if ctx is None or not ctx.cache_splits:
        return None
    return ctx.cache_splits.get(entry, {}).get(dim)


@contextlib.contextmanager
def use_mesh_context(ctx: MeshContext):
    """Install the thread-local context for the body of the ``with``."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev
