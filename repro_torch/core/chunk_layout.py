"""Chunked layouts of tensor state — the 'mesh topology' of the adaptation.

The paper's objects map onto tensor state as follows (DESIGN.md §2):

  mesh entity            -> a *chunk* (axis-aligned box) of one state array
  global number I        -> canonical enumeration: arrays in manifest order,
                            chunks in row-major grid order within each array
  cone order             -> global row-major order of elements *within* a box
                            (defined by global coordinates, never by device
                            layout — hence save/load-stable, like cones)
  DoF count (DOF array)  -> box volume (genuinely variable: edge chunks,
                            ragged expert shards)
  local DoF vector       -> per-rank concatenation of owned boxes' elements

A :class:`StateLayout` fixes the chunk grid of every array; ownership of
chunks by ranks is a separate, volatile concern (exactly as mesh distribution
is volatile while global numbers persist).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.comm import rank_radix

_INT = np.int64


@dataclasses.dataclass(frozen=True)
class Box:
    """Half-open axis-aligned box: [start[d], stop[d]) per dim."""

    start: tuple[int, ...]
    stop: tuple[int, ...]

    def __post_init__(self):
        if len(self.start) != len(self.stop):
            raise ValueError(f"box start {self.start} and stop {self.stop} "
                             f"have different ranks")
        if not all(a <= b for a, b in zip(self.start, self.stop)):
            raise ValueError(f"inverted box: start {self.start} > "
                             f"stop {self.stop}")

    @property
    def ndim(self) -> int:
        return len(self.start)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(b - a for a, b in zip(self.start, self.stop))

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    def intersect(self, other: "Box") -> "Box | None":
        lo = tuple(max(a, b) for a, b in zip(self.start, other.start))
        hi = tuple(min(a, b) for a, b in zip(self.stop, other.stop))
        if any(l >= h for l, h in zip(lo, hi)):
            return None
        return Box(lo, hi)

    def contains(self, other: "Box") -> bool:
        return all(a <= c and d <= b for a, c, d, b in
                   zip(self.start, other.start, other.stop, self.stop))

    def slices(self, origin: "Box | None" = None) -> tuple[slice, ...]:
        """Slices into an array whose [0..shape) region is ``origin``
        (defaults to the global array)."""
        base = origin.start if origin is not None else (0,) * self.ndim
        return tuple(slice(a - o, b - o)
                     for a, b, o in zip(self.start, self.stop, base))


def row_major_ids(box: Box, within: Box) -> np.ndarray:
    """Row-major linear positions of ``box``'s elements *within* ``within``.

    This is the intra-entity DoF numbering: stable because it is defined by
    global coordinates (the paper's cone-derived DoF order, §2.2)."""
    if not within.contains(box):
        raise ValueError(f"box [{box.start}, {box.stop}) not contained in "
                         f"frame [{within.start}, {within.stop})")
    grids = np.meshgrid(*[np.arange(a - wa, b - wa, dtype=_INT)
                          for a, b, wa in
                          zip(box.start, box.stop, within.start)],
                        indexing="ij")
    lin = np.zeros(box.shape, dtype=_INT)
    stride = 1
    for d in reversed(range(box.ndim)):
        lin += grids[d] * stride
        stride *= within.shape[d]
    return lin.reshape(-1)


@dataclasses.dataclass(frozen=True)
class ChunkGrid:
    """Regular chunking of an array: dim d is cut at multiples of
    ``chunk_shape[d]`` (last chunk may be smaller — variable DoF counts)."""

    shape: tuple[int, ...]
    chunk_shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.chunk_shape):
            raise ValueError(f"array shape {self.shape} and chunk shape "
                             f"{self.chunk_shape} have different ranks")
        if not all(c >= 1 for c in self.chunk_shape):
            raise ValueError(f"chunk shape {self.chunk_shape} must be >= 1 "
                             f"in every dim")

    @property
    def counts(self) -> tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunk_shape))

    @property
    def num_chunks(self) -> int:
        return int(math.prod(self.counts))

    def chunk_box(self, ordinal: int) -> Box:
        idx = np.unravel_index(ordinal, self.counts)
        start = tuple(int(i) * c for i, c in zip(idx, self.chunk_shape))
        stop = tuple(min(s + c, n) for s, c, n in
                     zip(start, self.chunk_shape, self.shape))
        return Box(start, stop)

    def chunks_intersecting(self, region: Box) -> list[int]:
        """Ordinals of chunks overlapping ``region`` (row-major order)."""
        lo = [a // c for a, c in zip(region.start, self.chunk_shape)]
        hi = [-(-b // c) for b, c in zip(region.stop, self.chunk_shape)]
        ranges = [range(a, min(b, n)) for a, b, n in
                  zip(lo, hi, self.counts)]
        out = []
        for idx in np.ndindex(*[len(r) for r in ranges]):
            multi = tuple(ranges[d][i] for d, i in enumerate(idx))
            out.append(int(np.ravel_multi_index(multi, self.counts)))
        return sorted(out)

    def iter_boxes(self) -> Iterator[tuple[int, Box]]:
        for o in range(self.num_chunks):
            yield o, self.chunk_box(o)

    # ------------------------------------------------- vectorised geometry
    def chunk_bounds(self, ordinals: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray]:
        """``chunk_box`` for a whole ordinal array at once: (starts, stops)
        as ``[n, ndim]`` int64 arrays — no per-chunk :class:`Box` objects on
        hot paths."""
        ordinals = np.asarray(ordinals, dtype=_INT)
        if len(self.shape) == 0:      # 0-d (scalar) arrays: one unit chunk
            empty = np.empty((len(ordinals), 0), dtype=_INT)
            return empty, empty
        multi = np.stack(np.unravel_index(ordinals, self.counts), axis=1
                         ) if ordinals.size else np.empty(
                             (0, len(self.shape)), _INT)
        cs = np.asarray(self.chunk_shape, dtype=_INT)
        starts = multi.astype(_INT) * cs
        stops = np.minimum(starts + cs, np.asarray(self.shape, dtype=_INT))
        return starts, stops

    def chunk_sizes(self, ordinals: np.ndarray) -> np.ndarray:
        """Box volumes of ``ordinals``, vectorised (the DOF column)."""
        starts, stops = self.chunk_bounds(ordinals)
        return np.prod(stops - starts, axis=1, dtype=_INT)

    def intersections(self, box_starts: np.ndarray, box_stops: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray, np.ndarray]:
        """All (box, chunk) intersections of region boxes given as
        ``[nbox, ndim]`` start/stop arrays, flattened in (box, ascending
        chunk ordinal) order — the row-per-intersection table the flat
        resharders walk instead of per-rank ``chunks_intersecting`` loops.

        Returns ``(box_row, ordinal, inter_start, inter_stop, chunk_start)``
        with the bound arrays ``[n_inter, ndim]``."""
        box_starts = np.asarray(box_starts, dtype=_INT)
        box_stops = np.asarray(box_stops, dtype=_INT)
        nbox, nd = box_starts.shape
        cs = np.asarray(self.chunk_shape, dtype=_INT)
        counts = np.asarray(self.counts, dtype=_INT)
        lo = box_starts // cs
        hi = np.minimum(-(-box_stops // cs), counts)
        len_d = np.maximum(hi - lo, 0)                  # [nbox, nd]
        # zero-volume boxes intersect nothing (Box.intersect returns None)
        len_d[(box_stops <= box_starts).any(axis=1)] = 0
        nch = np.prod(len_d, axis=1, dtype=_INT)
        rep = np.repeat(np.arange(nbox, dtype=_INT), nch)
        # mixed-radix decompose the per-box chunk index, row-major (last
        # dim fastest) — enumeration order == ascending ravel ordinal
        j = np.arange(len(rep), dtype=_INT) - np.repeat(
            np.cumsum(nch) - nch, nch)
        multi = np.empty((len(rep), nd), dtype=_INT)
        for d in reversed(range(nd)):
            multi[:, d] = lo[rep, d] + j % len_d[rep, d]
            j //= len_d[rep, d]
        if nd == 0:                   # 0-d arrays: the single unit chunk
            ords = np.zeros(len(rep), dtype=_INT)
        else:
            stride = np.concatenate(
                [np.cumprod(counts[::-1])[::-1][1:], [1]]).astype(_INT)
            ords = multi @ stride
        cstart = multi * cs
        cstop = np.minimum(cstart + cs, np.asarray(self.shape, dtype=_INT))
        istart = np.maximum(box_starts[rep], cstart)
        istop = np.minimum(box_stops[rep], cstop)
        return rep, ords, istart, istop, cstart


def box_element_positions(inner_start: np.ndarray, inner_stop: np.ndarray,
                          outers: Sequence[tuple[np.ndarray, np.ndarray]]
                          ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Row-major linear positions of every element of every inner box,
    within one or more outer frames, flattened in (inner box, row-major)
    order — the vectorised form of per-box :func:`row_major_ids` calls.

    ``inner_start``/``inner_stop`` are ``[n, ndim]``; each outer frame is an
    ``(outer_start [n, ndim], outer_shape [n, ndim])`` pair aligned to the
    inner boxes.  Returns ``(box_row, [lin per frame])`` — computing every
    frame in the same pass shares the one mixed-radix coordinate decode."""
    inner_start = np.asarray(inner_start, dtype=_INT)
    inner_stop = np.asarray(inner_stop, dtype=_INT)
    n, nd = inner_start.shape
    shape = inner_stop - inner_start
    sizes = np.prod(shape, axis=1, dtype=_INT)
    rep = np.repeat(np.arange(n, dtype=_INT), sizes)
    j = np.arange(len(rep), dtype=_INT) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    if nd == 1:
        # 1-D fast path: the within-box coordinate IS ``j`` — skip the
        # mixed-radix decode entirely (flat tensor state is the common case)
        return rep, [
            j + np.repeat(inner_start[:, 0]
                          - np.asarray(ostart, dtype=_INT)[:, 0], sizes)
            for ostart, _oshape in outers]
    outs = [np.zeros(len(rep), dtype=_INT) for _ in outers]
    strides = []
    for ostart, oshape in outers:
        st = np.ones((n, nd), dtype=_INT)
        if nd > 1:
            st[:, :-1] = np.cumprod(
                np.asarray(oshape, dtype=_INT)[:, :0:-1], axis=1)[:, ::-1]
        strides.append(st)
    for d in reversed(range(nd)):
        c = j % shape[rep, d]
        j //= shape[rep, d]
        for k, (ostart, _oshape) in enumerate(outers):
            off = inner_start[rep, d] - np.asarray(ostart, dtype=_INT)[rep, d]
            outs[k] += (off + c) * strides[k][rep, d]
    return rep, outs


@dataclasses.dataclass(frozen=True)
class RegionPlan:
    """Flat decomposition of per-rank target regions into chunk
    intersections and elements — ONE rank-tagged table per phase instead of
    nested ``for m in range(M): for box: for chunk`` Python walks (the
    save-side counterpart of the loader's :class:`TopoForest` discipline).

    Enumeration order matches the historical per-rank walk exactly: boxes
    rank-major in plan order, intersecting chunks ascending per box,
    elements row-major per intersection — so star forests built from these
    arrays are bit-identical to the per-rank formulation.
    """

    M: int
    box_rank: np.ndarray       # [nbox] target rank of each region box
    box_counts: np.ndarray     # [M] region boxes per rank
    box_shape: np.ndarray      # [nbox, nd]
    box_sizes: np.ndarray      # [nbox] box volumes
    needed_ord: np.ndarray     # per-rank sorted unique chunk ordinals, flat
    needed_counts: np.ndarray  # [M]
    inter_box: np.ndarray      # [ni] box row of each (box, chunk) overlap
    inter_pos: np.ndarray      # [ni] position into needed_ord
    inter_sizes: np.ndarray    # [ni] overlap volumes
    elem_within: np.ndarray    # [ne] row-major id within the owning chunk
    elem_target: np.ndarray    # [ne] position into the concatenated boxes
    elem_counts: np.ndarray    # [M] elements per rank

    def scatter_to_boxes(self, vals: np.ndarray, dtype) -> list[list[np.ndarray]]:
        """Scatter per-element values (in plan enumeration order) into the
        target boxes: one fancy assignment into the concatenated box buffer,
        then per-box reshaped views grouped per rank — the shared epilogue
        of the tensor loader and the in-memory resharder."""
        out_flat = np.empty(int(self.box_sizes.sum()), dtype=dtype)
        out_flat[self.elem_target] = vals
        offs = np.concatenate([[0], np.cumsum(self.box_sizes)]).astype(_INT)
        bufs = [out_flat[a:b].reshape(tuple(map(int, shp))) for a, b, shp in
                zip(offs[:-1], offs[1:], self.box_shape)]
        bb = np.concatenate([[0], np.cumsum(self.box_counts)]).astype(_INT)
        return [bufs[a:b] for a, b in zip(bb[:-1], bb[1:])]


def plan_regions(grid: ChunkGrid, regions: Sequence[Sequence[Box]]
                 ) -> RegionPlan:
    """Build the :class:`RegionPlan` for ``regions[rank] = [Box, ...]``."""
    M = len(regions)
    nd = len(grid.shape)
    box_counts = np.asarray([len(r) for r in regions], dtype=_INT)
    box_rank = np.repeat(np.arange(M, dtype=_INT), box_counts)
    boxes = [b for regs in regions for b in regs]
    bstart = np.array([b.start for b in boxes],
                      dtype=_INT).reshape(len(boxes), nd)
    bstop = np.array([b.stop for b in boxes],
                     dtype=_INT).reshape(len(boxes), nd)
    ibox, iord, istart, istop, icstart = grid.intersections(bstart, bstop)
    # (rank, ordinal) packed needed-chunk keys — shared guarded radix
    radix = rank_radix(M, grid.num_chunks)
    key = box_rank[ibox] * radix + iord
    needed_key = np.unique(key)
    icstop = np.minimum(icstart + np.asarray(grid.chunk_shape, dtype=_INT),
                        np.asarray(grid.shape, dtype=_INT))
    _, (within, tlin) = box_element_positions(
        istart, istop,
        [(icstart, icstop - icstart), (bstart[ibox], bstop[ibox] - bstart[ibox])])
    box_sizes = np.prod(bstop - bstart, axis=1, dtype=_INT)
    box_base = (np.concatenate([[0], np.cumsum(box_sizes)])
                if len(box_sizes) else np.zeros(1, _INT)).astype(_INT)
    inter_sizes = np.prod(istop - istart, axis=1, dtype=_INT)
    # element-level ranks/targets derive from the intersection table by
    # repetition — never a per-element gather
    return RegionPlan(
        M=M,
        box_rank=box_rank,
        box_counts=box_counts,
        box_shape=bstop - bstart,
        box_sizes=box_sizes,
        needed_ord=needed_key % radix,
        needed_counts=np.bincount(needed_key // radix, minlength=M
                                  ).astype(_INT),
        inter_box=ibox,
        inter_pos=np.searchsorted(needed_key, key).astype(_INT),
        inter_sizes=inter_sizes,
        elem_within=within,
        elem_target=np.repeat(box_base[ibox], inter_sizes) + tlin,
        elem_counts=np.bincount(box_rank[ibox], weights=inter_sizes,
                                minlength=M).astype(_INT),
    )


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    name: str
    shape: tuple[int, ...]
    dtype: str
    chunk_shape: tuple[int, ...]

    @property
    def grid(self) -> ChunkGrid:
        return ChunkGrid(self.shape, self.chunk_shape)

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def full_box(self) -> Box:
        return Box((0,) * len(self.shape), self.shape)


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Ordered collection of chunked arrays — the checkpoint 'topology'."""

    arrays: tuple[ArraySpec, ...]

    def __post_init__(self):
        names = [a.name for a in self.arrays]
        if len(set(names)) != len(names):
            dup = sorted(n for n in set(names) if names.count(n) > 1)
            raise ValueError(f"duplicate array names: {dup}")

    def spec(self, name: str) -> ArraySpec:
        return next(a for a in self.arrays if a.name == name)

    @property
    def names(self) -> list[str]:
        return [a.name for a in self.arrays]

    def to_json(self) -> list[dict]:
        return [dataclasses.asdict(a) for a in self.arrays]

    @staticmethod
    def from_json(data: Sequence[dict]) -> "StateLayout":
        return StateLayout(tuple(
            ArraySpec(d["name"], tuple(d["shape"]), d["dtype"],
                      tuple(d["chunk_shape"])) for d in data))


def default_chunk_shape(shape: tuple[int, ...], target_elems: int = 1 << 20,
                        shard_grid: tuple[int, ...] | None = None
                        ) -> tuple[int, ...]:
    """Pick a chunk shape: aligned to the sharding grid (each device shard is
    a whole number of chunks — the owner-writes-no-ghosts invariant), then cut
    along the leading dims toward ``target_elems`` per chunk (write-balance:
    the paper's equal-size partition keeps writers balanced)."""
    if shard_grid is None:
        shard_grid = (1,) * len(shape)
    chunk = [max(1, -(-s // g)) for s, g in zip(shape, shard_grid)]
    d = 0
    while math.prod(chunk) > target_elems and d < len(chunk):
        over = math.prod(chunk) // target_elems
        if over <= 1:
            break
        cut = min(chunk[d], max(1, over))
        chunk[d] = max(1, chunk[d] // cut)
        d += 1
    return tuple(chunk)
