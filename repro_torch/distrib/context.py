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

Where the sharded train and prefill steps split a family's compute over
the model axis (tensor parallelism: the transformer family), the context
carries that axis (:class:`ModelAxis`), and :func:`shard_hint` does what
GSPMD does around the reference's hint: it places the activation where
the rule table puts it (:func:`model_split`), summing, gathering or
slicing over the model axis through ``distrib/tensor_parallel.py``.
Without a model axis the hint returns its input, as the reference's does
without a mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

from repro_torch.distrib import tensor_parallel as tp
from repro_torch.distrib.rules import mesh_shape

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
class ModelAxis:
    """The model mesh axis of a step that splits its compute over it:
    its process group (ranks in coordinate order), its size (> 1) and this
    process's coordinate on it."""
    group: object
    size: int
    rank: int


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object          # torch DeviceMesh, or {axis: 1} for one device
    dp_axes: tuple[str, ...] = ("data",)     # batch-parallel mesh axes
    ep_axis: str = "model"                   # expert-parallel mesh axis
    rules: object = None                     # RuleTable for activation hints
    # the sharded decode step's cache: {entry: {dim: DimSplit}} for every
    # dim but the batch one that a mesh axis of several processes splits
    cache_splits: dict | None = None
    # the model axis, where the step splits the compute over it
    model: ModelAxis | None = None

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)


def model_axis() -> ModelAxis | None:
    """The installed context's model axis, where the step splits its
    compute over it; else None."""
    ctx = mesh_context()
    return None if ctx is None else ctx.model


def model_split(logical_axes: tuple[str | None, ...],
                shape: tuple[int, ...]) -> int | None:
    """The dim of an activation of global ``shape`` and ``logical_axes``
    that the installed context splits over the model axis: the rule
    table's spec for it (``RuleTable.spec_for``: the first logical dim
    wins, a dim the axis does not divide is whole); None where the
    activation is whole on every process of the axis."""
    ctx = mesh_context()
    if ctx is None or ctx.model is None:
        return None
    spec = ctx.rules.spec_for(tuple(logical_axes), tuple(shape),
                              mesh_shape(ctx.mesh))
    for d, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return d
    return None


def split_of(dim_size: int) -> DimSplit:
    """This process's part of a dim of ``dim_size`` split over the
    installed context's model axis."""
    ax = model_axis()
    n = dim_size // ax.size
    return DimSplit(ax.rank * n, (ax.rank + 1) * n, dim_size, ax.group)


def shard_hint(x, logical_axes: tuple[str | None, ...],
               shape: tuple[int, ...] | None = None, *,
               partial: bool = False):
    """Activation placement by LOGICAL axis names.

    The reference constrains an activation's sharding here and GSPMD
    partitions the compute around it.  Here ``x`` is this process's box of
    the activation of global ``shape`` (default ``x.shape``: ``x`` whole),
    split over the model axis on the one dim where its size differs from
    ``shape``'s, or, with ``partial``, this process's addend of it (the
    product of a contraction split over the model axis).  Returns this
    process's box of the activation where the rule table places it
    (:func:`model_split`): a partial is summed over the axis
    (reduce-out); a whole activation the rule splits is sliced
    (split-in); a split one the rule keeps whole is gathered (gather-out);
    one already in place is returned as it is.  Without a model axis in
    the context, ``x`` is returned as it is."""
    ax = model_axis()
    if ax is None:
        return x
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if len(shape) != x.dim():
        raise ValueError(f"shard_hint: x {tuple(x.shape)} is not a box of "
                         f"an activation of {shape}")
    want = model_split(logical_axes, shape)
    have = [d for d, (a, b) in enumerate(zip(x.shape, shape)) if a != b]
    if len(have) > 1 or (have and (partial or x.shape[have[0]] * ax.size
                                   != shape[have[0]])):
        raise ValueError(f"shard_hint: x {tuple(x.shape)} is not this "
                         f"process's box of an activation of {shape} split "
                         f"over {ax.size} processes")
    if partial:
        x = tp.reduce_from_group(x, ax.group)
    elif have and have[0] != want:
        x = tp.gather_from_group(x, ax.group, have[0])
    elif have:
        return x
    return x if want is None else tp.split_to_group(x, ax.group, want)


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
