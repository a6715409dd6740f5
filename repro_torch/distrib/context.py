"""Step-time mesh context, the counterpart of the JAX package's
``distrib/context.py``.

A step builder that partitions its compute over a mesh installs a
:class:`MeshContext` for the duration of a step, and model code reads it
through :func:`mesh_context`; with none installed the models run their
mesh-free paths, as in the reference.  The port's sharded step does not
partition its compute yet (every process runs the whole step on gathered
parameters: ``train/step.py``), so it installs none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object                             # torch DeviceMesh
    dp_axes: tuple[str, ...] = ("data",)     # batch-parallel mesh axes
    ep_axis: str = "model"                   # expert-parallel mesh axis
    fsdp_axis: object = "data"               # parameter-shard (ZeRO-3) axes
    rules: object = None                     # RuleTable for activation hints

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)


def shard_hint(x, logical_axes: tuple[str | None, ...]):
    """Activation placement by LOGICAL axis names.

    The reference constrains an activation's sharding here and returns the
    same values; GSPMD then partitions the compute around it.  The port's
    sharded step gathers the parameters and runs the whole step on every
    process (``train/step.py``), so no activation is sharded and the hint
    returns ``x`` as it is: the values are the reference's either way."""
    return x


def mesh_context() -> MeshContext | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_mesh_context(ctx: MeshContext):
    """Install the thread-local context for the body of the ``with``."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev
