"""Per-architecture sharding rule tables (logical axis -> mesh axes), the
counterpart of the JAX package's ``distrib/rules.py``.

The tables, their per-arch overrides and the perf overrides are the
reference's, entry for entry; a spec is a plain tuple with the reference's
``PartitionSpec`` entries (``None``, one mesh-axis name, or a tuple of
names).  ``placements_for`` turns a spec into the DTensor placements of a
2-D (or 3-D) ``DeviceMesh``: a tensor dim sharded over mesh axes becomes
``Shard(d)`` on each of those mesh dims, and every other mesh dim is
``Replicate()``.  Sharding one dim over several mesh axes in mesh-dim order
gives JAX's major-to-minor order (the first axis the major one), so a
DTensor's local shard is the box ``sharding.device_box`` gives the same
device.

The baseline layout is 2-D "FSDP + TP": the ``model`` axis carries heads,
MLP hidden and vocab; the ``data`` axis carries the batch and the ZeRO-3
embed dim; ``pod`` (multi-pod) is pure data parallelism.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from repro_torch.core.chunk_layout import Box
from repro_torch.distrib import sharding

AxisEntry = str | tuple[str, ...] | None


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, of a mapping, or of any
    object whose ``shape`` is such a mapping (the reference's meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = mesh if isinstance(mesh, Mapping) else mesh.shape
    return {str(k): int(v) for k, v in shape.items()}


@dataclasses.dataclass(frozen=True)
class RuleTable:
    """Logical-name -> mesh-axes table + derived helpers."""

    table: Mapping[str, AxisEntry]
    batch_axes: tuple[str, ...] = ("data",)

    def spec_for(self, logical_axes: tuple[str | None, ...],
                 shape: tuple[int, ...] | None = None,
                 mesh=None) -> tuple[AxisEntry, ...]:
        """The spec of one array.  A mesh axis is used at most once per
        array (first logical dim wins); entries whose dim size is not
        divisible by the mesh-axis extent degrade to replication."""
        sizes = mesh_shape(mesh) if mesh is not None else None
        out: list[AxisEntry] = []
        used: set[str] = set()
        for d, name in enumerate(logical_axes):
            entry = self.table.get(name) if name is not None else None
            axes = _as_tuple(entry)
            axes = tuple(a for a in axes if a not in used)
            if shape is not None and sizes is not None and axes:
                if shape[d] % math.prod(sizes[a] for a in axes) != 0:
                    axes = ()
            used.update(axes)
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def sharding_for(self, mesh, logical_axes, shape=None) -> list:
        return placements_for(self.spec_for(logical_axes, shape, mesh), mesh)

    def batch_spec(self, ndim: int) -> tuple[AxisEntry, ...]:
        """Leading-dim batch sharding for step inputs."""
        if ndim == 0:
            return ()
        axes = self.batch_axes
        return (axes if len(axes) > 1 else axes[0],) + (None,) * (ndim - 1)


def _as_tuple(entry: AxisEntry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


# ------------------------------------------------------------ base tables
def base_table(multi_pod: bool, *, fsdp: bool = True) -> dict[str, AxisEntry]:
    """The baseline FSDP+TP layout shared by all archs."""
    return {
        # tensor-parallel dims
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "expert_mlp": None,          # experts already shard over model
        # ZeRO-3 dims
        "embed": "data" if fsdp else None,
        "expert_in": "data" if fsdp else None,
        # activations / step state
        "batch": ("pod", "data") if multi_pod else "data",
        # KV caches shard their SEQUENCE dim over model (sequence-parallel
        # KV: no arch has enough kv heads for a 16-wide model axis)
        "kv_seq": "model",
        "layers": None,
    }


_ARCH_OVERRIDES: dict[str, dict[str, AxisEntry]] = {
    "whisper-base": {"vocab": None, "embed": "data"},
    "recurrentgemma-9b": {"kv_heads": None},
    "xlstm-350m": {"heads": None},
}


def rules_for(arch: str, *, multi_pod: bool = False, fsdp: bool = True,
              shape_name: str | None = None, perf: bool = True,
              extra: Mapping[str, AxisEntry] | None = None) -> RuleTable:
    """``perf=False`` gives the paper-faithful baseline; ``perf=True``
    additionally applies configs/perf.py's overrides for ``shape_name``."""
    table = base_table(multi_pod, fsdp=fsdp)
    table.update(_ARCH_OVERRIDES.get(arch, {}))
    if perf and shape_name is not None:
        from repro_torch.configs.perf import rule_overrides

        mesh_tag = "multi" if multi_pod else "single"
        for k, v in rule_overrides(arch, shape_name, mesh_tag).items():
            if not multi_pod and v is not None:
                axes = _as_tuple(v)
                if "pod" in axes:
                    v = tuple(a for a in axes if a != "pod") or None
            table[k] = v
    if extra:
        table.update(extra)
    batch_axes = _as_tuple(table["batch"])
    return RuleTable(table=table, batch_axes=batch_axes)


# ------------------------------------------------------- specs and DTensors
def placements_for(spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (one per mesh dim):
    ``Shard(d)`` on every mesh dim that names an axis of tensor dim ``d``,
    ``Replicate()`` elsewhere.  A dim sharded over several axes must name
    them in the mesh's dim order (the only order plain ``Shard`` places
    major-to-minor); another order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh {names} has no axis {a!r}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: dim {d} is sharded over {axes}, "
                             f"not in the mesh's dim order {names}")
        for i in dims:
            out[i] = Shard(d)
    return out


def spec_of(placements, mesh, ndim: int) -> tuple[AxisEntry, ...]:
    """The spec ``placements`` stand for on ``mesh`` (the inverse of
    ``placements_for``), ``ndim`` entries long."""
    names = list(mesh_shape(mesh))
    spec: list[tuple[str, ...]] = [() for _ in range(ndim)]
    for name, p in zip(names, placements):
        if p.is_shard():
            spec[p.dim] = spec[p.dim] + (name,)
        elif not p.is_replicate():
            raise ValueError(f"placement {p} is neither Shard nor Replicate")
    return tuple(a if len(a) > 1 else (a[0] if a else None) for a in spec)


def coords_of(mesh) -> dict[str, int]:
    """This process's coordinate on ``mesh``, by axis name."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def local_box(shape, mesh, placements) -> Box:
    """The box of the global array that this process's local shard holds."""
    return sharding.device_box(tuple(shape), mesh_shape(mesh),
                               spec_of(placements, mesh, len(shape)),
                               coords_of(mesh))


def owns(mesh, placements, ndim: int) -> bool:
    """The ghost rule: this process saves its shard iff its coordinate is 0
    on every mesh dim the tensor is replicated over."""
    return sharding.is_owner(mesh_shape(mesh),
                             spec_of(placements, mesh, ndim),
                             coords_of(mesh), ndim)


def from_local(local, mesh, placements, shape):
    """A DTensor of global ``shape`` from this process's local shard, with no
    communication (every shard is even: ``spec_for`` replicates any dim its
    mesh axes do not divide)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(n) for n in shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


# ------------------------------------------------------- tree-level helpers
def batch_shardings(mesh, rules: RuleTable, batch_specs: dict) -> dict:
    """Step-input placements: leading dim over the batch axes (shapes whose
    leading dim does not divide the batch extent are replicated)."""
    sizes = mesh_shape(mesh)
    bsz = math.prod(sizes[a] for a in rules.batch_axes)
    out = {}
    for k, sds in batch_specs.items():
        if sds.shape and sds.shape[0] % bsz == 0 and sds.shape[0] > 0:
            out[k] = placements_for(rules.batch_spec(len(sds.shape)), mesh)
        else:
            out[k] = placements_for((), mesh)
    return out


def cache_shardings(mesh, rules: RuleTable, cache_specs: dict,
                    cache_axes: dict) -> dict:
    """Serving-cache placements: each entry by its logical axes
    (``api.cache_axes()``), as the reference's ``cache_shardings``."""
    return {k: rules.sharding_for(mesh, tuple(cache_axes[k]),
                                  tuple(sds.shape))
            for k, sds in cache_specs.items()}
