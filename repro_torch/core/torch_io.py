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
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.chunk_layout import ArraySpec, Box, StateLayout
from repro_torch.core.comm import Comm
from repro_torch.core.resharder import sweep_steps
from repro_torch.core.store import HOST_WORDS, np_dtype
from repro_torch.core.tensor_ckpt import ArrayShard, PerRankState, TensorCheckpoint
from repro_torch.device import resolve_device
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


def layout_from_torch(tree: Mapping[str, torch.Tensor], subdiv: int = 16
                      ) -> StateLayout:
    """Mesh-agnostic chunk grid: the largest power-of-two split (<= subdiv)
    per dim.  One device holds each tensor whole, so the shard grid is all
    ones (the same layout ``layout_from_jax`` gives unsharded arrays)."""
    names, leaves = tree_names(tree)
    specs = []
    for name, leaf in zip(names, leaves):
        shape = tuple(int(s) for s in leaf.shape)
        grid = tuple(_grid_factor(n, 1, subdiv) for n in shape)
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
                t = tensors[name]
                if tuple(t.shape) != spec.shape or dtype_name(t.dtype) != spec.dtype:
                    raise ValueError(
                        f"{name}: tensor {tuple(t.shape)} {t.dtype} does not "
                        f"match the layout's {spec.shape} {spec.dtype}")
                # bytes along the last dim: the pack moves bytes, any dtype
                views[name] = chunk_major(t, spec.chunk_shape).view(torch.uint8)
    out: PerRankState = []
    for rank_own in ownership:
        regions, total = [], 0           # (name, ordinals, offset, chunk bytes)
        for name, ords in rank_own.items():
            ords = np.asarray(ords, dtype=_INT)
            v = views[name]
            cb = v.shape[1] * v.shape[2]
            regions.append((name, ords, total, cb))
            total += -(-len(ords) * cb // _ALIGN) * _ALIGN
        device = next(iter(views.values())).device if views else "cpu"
        staging = torch.empty(total, dtype=torch.uint8, device=device)
        for name, ords, off, cb in regions:
            v = views[name]
            pack_chunks(v, ords, out=staging[off:off + len(ords) * cb].view(
                len(ords), v.shape[1], v.shape[2]))
        host = staging.cpu().numpy()      # the rank's one device-to-host copy
        rank_state: dict[str, ArrayShard] = {}
        for name, ords, off, cb in regions:
            spec = layout.spec(name)
            dt = np_dtype(spec.dtype)
            rank_state[name] = ArrayShard(ords, {
                int(o): host[off + i * cb:off + (i + 1) * cb].view(dt)
                .reshape(spec.chunk_shape)
                for i, o in enumerate(ords)})
        out.append(rank_state)
    return out


def _all_chunks(layout: StateLayout) -> dict[str, np.ndarray]:
    return {spec.name: np.arange(spec.grid.num_chunks, dtype=_INT)
            for spec in layout.arrays}


def snapshot_torch(layout: StateLayout, tree: Mapping[str, torch.Tensor]
                   ) -> PerRankState:
    """Device -> host snapshot of this process's owned chunks.

    One process holds every tensor whole, exactly once, so it owns every
    chunk (the replica-0 rule of ``jax_io`` leaves no ghosts here).  The
    blocks are views of a fresh host copy, safe against later in-place
    updates of the tensors."""
    return shards_from_tensors(layout, tree, [_all_chunks(layout)])


def save_torch(ck: TensorCheckpoint, tree: Mapping[str, torch.Tensor], step: int,
               ownership: list[dict[str, np.ndarray]] | None = None) -> None:
    """Save a flat dict of tensors; must follow a prior ``save_layout``
    (``ck.save_layout(layout_from_torch(tree))``).  ``ownership`` (one dict
    of owned chunk ordinals per rank, e.g. ``balanced_chunk_partition``)
    saves as that many ranks; the default is this process as one rank."""
    layout = ck.layout()
    per_rank = (snapshot_torch(layout, tree) if ownership is None
                else shards_from_tensors(layout, tree, ownership))
    ck.save_state(per_rank, Comm(len(per_rank)), step)


def load_torch(ck: TensorCheckpoint, target: Mapping[str, torch.Tensor], step: int,
               device="cuda") -> dict[str, torch.Tensor]:
    """Load into the names, shapes and dtypes of ``target`` (tensors, e.g.
    on the ``meta`` device) on one rank: every array whole, whatever rank
    count saved it.  One host-to-device copy per array."""
    dev = resolve_device(device)
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
