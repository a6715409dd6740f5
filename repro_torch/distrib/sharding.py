"""Pure box math for meshes and PartitionSpecs.

Maps (global shape, mesh shape, partition spec) to per-device boxes and
replica groups — with *no* device allocation, so the same code serves the
512-device dry-run, the checkpoint planner, and real runtimes.

Replica handling mirrors the paper's ghost rule (§2.1.1): an array shard
replicated over unspecified mesh axes has one *owner* (the replica with
coordinate 0 on every unsharded axis); other replicas are ghosts and save
nothing.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.chunk_layout import Box
from repro_torch.core.star_forest import partition_starts

AxisSpec = None | str | tuple[str, ...]


def _axes_of(entry: AxisSpec) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_axes(spec: Sequence[AxisSpec]) -> set[str]:
    out: set[str] = set()
    for e in spec:
        out.update(_axes_of(e))
    return out


def validate_spec(shape: Sequence[int], mesh_shape: Mapping[str, int],
                  spec: Sequence[AxisSpec]) -> None:
    assert len(spec) <= len(shape), f"spec {spec} longer than shape {shape}"
    seen: set[str] = set()
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        for ax in axes:
            assert ax in mesh_shape, f"unknown mesh axis {ax!r}"
            assert ax not in seen, f"mesh axis {ax!r} used twice"
            seen.add(ax)
        k = math.prod(mesh_shape[ax] for ax in axes) if axes else 1
        assert shape[d] % k == 0, (
            f"dim {d} of shape {tuple(shape)} not divisible by {k} "
            f"(axes {axes})")


def shard_shape(shape: Sequence[int], mesh_shape: Mapping[str, int],
                spec: Sequence[AxisSpec]) -> tuple[int, ...]:
    out = list(shape)
    for d, entry in enumerate(spec):
        k = math.prod(mesh_shape[ax] for ax in _axes_of(entry))
        out[d] //= k
    return tuple(out)


def device_box(shape: Sequence[int], mesh_shape: Mapping[str, int],
               spec: Sequence[AxisSpec], coords: Mapping[str, int]) -> Box:
    """The box of the device at mesh coordinates ``coords``."""
    start, stop = [], []
    for d in range(len(shape)):
        entry = spec[d] if d < len(spec) else None
        axes = _axes_of(entry)
        idx, mult = 0, 1
        for ax in reversed(axes):
            idx += coords[ax] * mult
            mult *= mesh_shape[ax]
        k = mult
        sz = shape[d] // k
        start.append(idx * sz)
        stop.append((idx + 1) * sz)
    return Box(tuple(start), tuple(stop))


def is_owner(mesh_shape: Mapping[str, int], spec: Sequence[AxisSpec],
             coords: Mapping[str, int], ndim: int) -> bool:
    """Owner = replica with coordinate 0 on every axis the array is NOT
    sharded over (ghost-exclusion rule)."""
    used = spec_axes(spec[:ndim])
    return all(coords[ax] == 0 for ax in mesh_shape if ax not in used)


def all_device_coords(mesh_shape: Mapping[str, int]
                      ) -> list[dict[str, int]]:
    axes = list(mesh_shape)
    return [dict(zip(axes, c))
            for c in itertools.product(*[range(mesh_shape[a]) for a in axes])]


@dataclasses.dataclass(frozen=True)
class ShardingRule:
    """Logical-axis sharding rules: each array has a tuple of logical axis
    names; the rule table maps logical names to mesh axes.  Changing the
    table IS the hillclimbing knob — arrays and models never hardcode mesh
    axes."""

    table: Mapping[str, AxisSpec]

    def spec_for(self, logical_axes: Sequence[str | None]
                 ) -> tuple[AxisSpec, ...]:
        out: list[AxisSpec] = []
        used: set[str] = set()
        for name in logical_axes:
            entry = self.table.get(name) if name is not None else None
            axes = tuple(ax for ax in _axes_of(entry) if ax not in used)
            used.update(axes)
            out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        return tuple(out)


def rank_regions(shape: Sequence[int], mesh_shape: Mapping[str, int],
                 spec: Sequence[AxisSpec], nranks: int,
                 devices_per_rank: int | None = None
                 ) -> list[list[Box]]:
    """Group device boxes into per-rank (per-host) region lists, deduplicating
    replicas (ghosts contribute nothing).  Devices are assigned to ranks in
    mesh-major order, ``devices_per_rank`` each (default: evenly)."""
    coords = all_device_coords(mesh_shape)
    ndev = len(coords)
    if devices_per_rank is None:
        assert ndev % nranks == 0
        devices_per_rank = ndev // nranks
    regions: list[list[Box]] = [[] for _ in range(nranks)]
    for i, c in enumerate(coords):
        r = i // devices_per_rank
        if is_owner(mesh_shape, spec, c, len(shape)):
            b = device_box(shape, mesh_shape, spec, c)
            if b.size and b not in regions[r]:
                regions[r].append(b)
    return regions


def canonical_regions(shape: Sequence[int], nranks: int) -> list[list[Box]]:
    """Row-major equal split of an array over ranks (the canonical partition
    lifted to boxes) — a convenient loader target for post-processing."""
    total = int(math.prod(shape))
    if total == 0:
        return [[] for _ in range(nranks)]
    lead = shape[0]
    starts = partition_starts(lead, nranks)
    return [[] if int(starts[m]) == int(starts[m + 1])
            else [Box((int(starts[m]),) + (0,) * (len(shape) - 1),
                      (int(starts[m + 1]),) + tuple(shape[1:]))]
            for m in range(nranks)]
