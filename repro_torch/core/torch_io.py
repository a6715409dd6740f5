"""PyTorch bridge: checkpoint a flat dict of tensors through the N-to-M core.

The counterpart of the JAX package's ``core/jax_io.py``.  The state is a
flat ``dict[str, torch.Tensor]`` (names sorted, as JAX flattens a dict).
The chunk grid is the same mesh-agnostic power-of-two grid, so the two
packages describe one state with one ``StateLayout`` and read each other's
stores.

Save side: each array is viewed chunk-major ([n_chunks, R, C], chunks in
ordinal order, each chunk's elements row-major in its box); for every rank,
the ``ckpt_pack`` kernel gathers that rank's owned chunks of every array
into ONE staging buffer on the device, which reaches the host in ONE copy.
The host blocks then go through the shared engine (``TensorCheckpoint``)
unchanged.  Load side: the engine assembles each target box on the host and
one host-to-device copy per array places it on the target device.

Across processes (``torch.distributed``; the state a dict of DTensors on a
``DeviceMesh``) there is one checkpoint rank per process, as in the
reference's production shape.  Each process packs the chunks of its owned
local shards (replica 0 of each: the ghost rule) and copies them to the host
once; rank 0 gathers every process's ``ArrayShard``s and alone runs the
engine and writes the store.  A load gathers every process's target box on
rank 0, which runs the engine for all of them and scatters each its blocks.
So the store format, the commit contract and the I/O plans are those of the
one-process engine: N processes write the store that one process writes
with ``save_torch(ownership=<the same N ownerships>)``.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.chunk_layout import ArraySpec, Box, StateLayout
from repro_torch.core.comm import Comm
from repro_torch.core.resharder import sweep_steps
from repro_torch.core.store import HOST_WORDS, np_dtype
from repro_torch.core.tensor_ckpt import ArrayShard, PerRankState, TensorCheckpoint
from repro_torch.device import resolve_device
from repro_torch.distrib import group as pg
from repro_torch.distrib.rules import from_local, local_box, owns
from repro_torch.kernels.ckpt_pack.ops import pack_chunks

_INT = np.int64
_ALIGN = 16          # byte alignment of each array's region in a staging buffer


def tree_names(tree: Mapping[str, torch.Tensor]
               ) -> tuple[list[str], list[torch.Tensor]]:
    """Stable names (sorted keys, JAX's dict order) + leaves of a flat dict."""
    names = sorted(tree)
    return names, [tree[n] for n in names]


def dtype_name(dtype: torch.dtype) -> str:
    """The stored name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def to_torch(arr: np.ndarray, name: str) -> torch.Tensor:
    """Host array of stored dtype ``name`` as a CPU tensor (no copy unless
    the array is read-only); bfloat16 arrives as 2-byte host words and is
    reinterpreted."""
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")       # (keeps 0-d arrays 0-d)
    if name in HOST_WORDS:
        return torch.from_numpy(arr.view(np.int16)).view(getattr(torch, name))
    return torch.from_numpy(arr)


def _grid_factor(n: int, shard_g: int, subdiv: int = 16) -> int:
    """Per-dim chunk count: a multiple of the current shard grid AND of
    the largest power-of-two divisor of n (capped at ``subdiv``), so that
    any later power-of-two re-sharding still tiles the chunk grid — the
    elastic-restart re-save case (paper §7's 'the loaded mesh is a new
    mesh' limitation, solved here by a mesh-agnostic chunk grid)."""
    if n == 0:
        return 1
    pow2 = 1
    while pow2 < subdiv and n % (pow2 * 2) == 0:
        pow2 *= 2
    g = max(shard_g, 1)
    # lcm(g, pow2) for g a divisor of n; fall back to g if not dividing
    cand = g * pow2 // math.gcd(g, pow2)
    return cand if n % cand == 0 else g


def _shard_grid(t: torch.Tensor) -> tuple[int, ...]:
    """Per-dim shard counts of a DTensor's placements (all ones for a plain
    tensor, which one device holds whole): the counterpart of
    ``jax_io._shard_grid``."""
    grid = [1] * t.dim()
    if isinstance(t, DTensor):
        for i, p in enumerate(t.placements):
            if p.is_shard():
                grid[p.dim] *= t.device_mesh.size(i)
    return tuple(grid)


def layout_from_torch(tree: Mapping[str, torch.Tensor], subdiv: int = 16
                      ) -> StateLayout:
    """Mesh-agnostic chunk grid: refines each tensor's shard grid (from its
    DTensor placements; all ones for a plain tensor, as ``layout_from_jax``
    gives unsharded arrays) to the largest power-of-two split (<= subdiv)
    per dim, so the same layout accepts re-saves from any power-of-two
    mesh."""
    names, leaves = tree_names(tree)
    specs = []
    for name, leaf in zip(names, leaves):
        shape = tuple(int(s) for s in leaf.shape)
        grid = tuple(_grid_factor(n, g, subdiv)
                     for n, g in zip(shape, _shard_grid(leaf)))
        chunk = tuple(max(1, n // g) for n, g in zip(shape, grid))
        specs.append(ArraySpec(name, shape, dtype_name(leaf.dtype), chunk))
    return StateLayout(tuple(specs))


def chunk_major(t: torch.Tensor, chunk: tuple[int, ...]) -> torch.Tensor:
    """``t`` as [n_chunks, R, C] in chunk-ordinal order (row-major over the
    grid), each chunk's elements row-major within its box; R is the product
    of the chunk's leading dims and C its last.  A reshape plus a permute
    (a copy unless the grid cuts only the leading dim)."""
    shape = tuple(t.shape)
    if not shape:
        return t.reshape(1, 1, 1)
    if any(n % c for n, c in zip(shape, chunk)):
        raise ValueError(f"chunk shape {chunk} does not tile {shape}: the "
                         f"device pack needs equal chunks")
    grid = [n // c for n, c in zip(shape, chunk)]
    nd = len(shape)
    split = [d for g, c in zip(grid, chunk) for d in (g, c)]
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    return t.reshape(split).permute(perm).reshape(
        math.prod(grid), math.prod(chunk[:-1]), chunk[-1]).contiguous()


def _checked_view(spec: ArraySpec, t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` (the block of ``spec``'s array of the given shape) chunk-major,
    as bytes along the last dim: the pack moves bytes, any dtype."""
    if tuple(t.shape) != tuple(shape) or dtype_name(t.dtype) != spec.dtype:
        raise ValueError(
            f"{spec.name}: tensor {tuple(t.shape)} {t.dtype} does not "
            f"match the layout's {tuple(shape)} {spec.dtype}")
    return chunk_major(t, spec.chunk_shape).view(torch.uint8)


def _pack(layout: StateLayout, items) -> dict[str, ArrayShard]:
    """One rank's ``ArrayShard``s from ``items`` = (name, chunk-major byte
    view [n, R, C], indices into the view, the chunks' global ordinals):
    ``ckpt_pack`` gathers every item's chunks into ONE staging buffer on the
    views' device, which comes to the host in ONE copy; the shard blocks are
    views of that host copy."""
    regions, total = [], 0      # (name, view, idx, ordinals, offset, bytes)
    for name, v, idx, ords in items:
        cb = v.shape[1] * v.shape[2]
        regions.append((name, v, idx, np.asarray(ords, dtype=_INT), total, cb))
        total += -(-len(ords) * cb // _ALIGN) * _ALIGN
    device = items[0][1].device if items else "cpu"
    staging = torch.empty(total, dtype=torch.uint8, device=device)
    for name, v, idx, ords, off, cb in regions:
        pack_chunks(v, idx, out=staging[off:off + len(ords) * cb].view(
            len(ords), v.shape[1], v.shape[2]))
    host = staging.cpu().numpy()          # the rank's one device-to-host copy
    rank_state: dict[str, ArrayShard] = {}
    for name, v, idx, ords, off, cb in regions:
        spec = layout.spec(name)
        dt = np_dtype(spec.dtype)
        rank_state[name] = ArrayShard(ords, {
            int(o): host[off + i * cb:off + (i + 1) * cb].view(dt)
            .reshape(spec.chunk_shape)
            for i, o in enumerate(ords)})
    return rank_state


def shards_from_tensors(layout: StateLayout, tensors: Mapping[str, torch.Tensor],
                        ownership: list[dict[str, np.ndarray]]) -> PerRankState:
    """Cut device tensors into per-rank ``ArrayShard``s — the device
    counterpart of ``tensor_ckpt.shards_from_arrays``.

    Per rank, ``ckpt_pack`` gathers the rank's owned chunks of every array
    into one staging buffer on the tensors' device, and that buffer comes to
    the host in one copy; the shard blocks are views of the host copy."""
    views: dict[str, torch.Tensor] = {}
    for rank_own in ownership:
        for name in rank_own:
            if name not in views:
                spec = layout.spec(name)
                views[name] = _checked_view(spec, tensors[name], spec.shape)
    return [_pack(layout, [(name, views[name], ords, ords)
                           for name, ords in rank_own.items()])
            for rank_own in ownership]


def is_sharded(tree: Mapping[str, torch.Tensor]) -> bool:
    """True when any leaf of ``tree`` is a DTensor."""
    return any(isinstance(t, DTensor) for t in tree.values())


def _holding(t: torch.Tensor) -> tuple[Box, torch.Tensor, bool]:
    """(box, local tensor, owned) of this process's part of ``t``.  A plain
    tensor counts as held whole by every process and owned by rank 0."""
    if isinstance(t, DTensor):
        mesh, placements = t.device_mesh, t.placements
        return (local_box(t.shape, mesh, placements), t.to_local(),
                owns(mesh, placements, t.dim()))
    shape = tuple(int(n) for n in t.shape)
    return Box((0,) * len(shape), shape), t, pg.rank() == 0


def _local_items(layout: StateLayout, tree: Mapping[str, torch.Tensor]):
    """The pack items of this process's owned local shards: each shard's
    chunks in ``chunk_major`` order of the local tensor, which is the order
    of ``grid.chunks_intersecting(box)`` (row-major over a sub-grid is
    monotone in the global ordinal)."""
    items = []
    for name in sorted(tree):
        box, local, owned = _holding(tree[name])
        if not owned:
            continue                            # ghost (paper section 2.1.1)
        spec = layout.spec(name)
        if any(a % c or b % c for a, b, c in zip(box.start, box.stop,
                                                 spec.chunk_shape)):
            raise ValueError(f"{name}: shard box {box} is not a whole number "
                             f"of {spec.chunk_shape} chunks")
        ords = spec.grid.chunks_intersecting(box)
        view = _checked_view(spec, local, box.shape)
        items.append((name, view, np.arange(len(ords), dtype=_INT), ords))
    return items


def snapshot_torch(layout: StateLayout, tree: Mapping[str, torch.Tensor]
                   ) -> PerRankState:
    """Device -> host snapshot of this process's owned chunks, as one rank.

    The process owns the chunks of its local part of each tensor whose
    replica it is 0 of (``_holding``: the replica-0 rule of ``jax_io``) and
    saves nothing of the others.  A plain tensor is held whole; on one
    process it owns every chunk.  The blocks are views of a fresh host
    copy, safe against later in-place updates of the tensors."""
    return [_pack(layout, _local_items(layout, tree))]


def gather_snapshot(layout: StateLayout, tree: Mapping[str, torch.Tensor],
                    group=None) -> PerRankState | None:
    """Every process's ``snapshot_torch`` on rank 0 of ``group`` (the
    default group if None), one checkpoint rank per process in rank order;
    None on the other processes."""
    return pg.gather_to_root(snapshot_torch(layout, tree)[0], group)


def save_torch(ck: TensorCheckpoint | None, tree: Mapping[str, torch.Tensor],
               step: int, ownership: list[dict[str, np.ndarray]] | None = None,
               *, group=None) -> None:
    """Save a flat dict of tensors; must follow a prior ``save_layout``
    (``ck.save_layout(layout_from_torch(tree))``).  ``ownership`` (one dict
    of owned chunk ordinals per rank, e.g. ``balanced_chunk_partition``)
    saves as that many simulated ranks of this process.

    Without it, each process of ``group`` (the default group if one is
    started, else this process alone) is one rank and saves its owned
    chunks (``snapshot_torch``).  Every process calls this; only rank 0's
    ``ck`` is used (the others may pass None), and when rank 0 fails every
    process raises."""
    if ownership is not None:
        ck.save_state(shards_from_tensors(ck.layout(), tree, ownership),
                      Comm(len(ownership)), step)
        return
    layout = pg.root_call(ck.layout if pg.rank(group) == 0 else None, group)
    per_rank = gather_snapshot(layout, tree, group)
    pg.root_call(lambda: ck.save_state(per_rank, Comm(len(per_rank)), step),
                 group)


def load_torch(ck: TensorCheckpoint | None, target: Mapping[str, torch.Tensor],
               step: int, device="cuda", *, mesh=None, shardings=None,
               group=None) -> dict[str, torch.Tensor]:
    """Load into the names, shapes and dtypes of ``target`` (tensors, e.g.
    on the ``meta`` device).  One host-to-device copy per array.

    Without a ``mesh``: on one rank, every array whole, whatever rank count
    saved it.  With a ``mesh`` and ``shardings`` (name -> placements on it):
    every process of ``group`` (the default group if None) calls this and
    gets DTensors on those placements; its plan is its local box of each
    array (replicas included: each loads its own copy), rank 0 runs the
    engine for every process's plan with ``ck`` (the others may pass None)
    and scatters each its blocks."""
    dev = resolve_device(device)
    if mesh is not None:
        return _load_sharded(ck, target, step, dev, mesh, shardings, group)
    names, leaves = tree_names(target)
    plan_rank = {name: [Box((0,) * leaf.dim(), tuple(int(s) for s in leaf.shape))]
                 for name, leaf in zip(names, leaves)}
    host = ck.load_state([plan_rank], Comm(1), step)[0]
    layout = ck.layout()
    out = {}
    for name, leaf in zip(names, leaves):
        t = to_torch(host[name][0], layout.spec(name).dtype).to(dev)
        out[name] = t if t.dtype == leaf.dtype else t.to(leaf.dtype)
    return out


def _load_sharded(ck, target, step, dev, mesh, shardings, group):
    names, leaves = tree_names(target)
    boxes = {name: local_box(leaf.shape, mesh, shardings[name])
             for name, leaf in zip(names, leaves)}
    plans = pg.gather_to_root({n: [b] for n, b in boxes.items()}, group)

    def load():
        host = ck.load_state(plans, Comm(len(plans)), step)
        layout = ck.layout()
        return [{n: (layout.spec(n).dtype, host[r][n][0]) for n in names}
                for r in range(len(plans))]

    blocks = pg.root_call(load, group, scatter=True)
    out = {}
    for name, leaf in zip(names, leaves):
        stored, arr = blocks[name]
        t = to_torch(arr, stored).to(dev)
        t = t if t.dtype == leaf.dtype else t.to(leaf.dtype)
        out[name] = from_local(t, mesh, shardings[name], leaf.shape)
    return out


def sweep_to_device(ck: TensorCheckpoint, arrays, device="cuda"):
    """Yield ``(step, {name: tensor})`` for every committed step of ``ck``'s
    series, loading only ``arrays`` whole onto one rank: the region plan
    covers every array once and ``sweep_steps`` narrows it to ``arrays``.
    One host-to-device copy per array."""
    dev = resolve_device(device)
    layout = ck.layout()
    plan = [{spec.name: [spec.full_box] for spec in layout.arrays}]
    for step, out in sweep_steps(ck, plan, Comm(1), arrays=list(arrays)):
        yield step, {name: to_torch(out[0][name][0],
                                    layout.spec(name).dtype).to(dev)
                     for name in arrays}
