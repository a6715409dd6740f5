"""DMPlex analogue: meshes as DAGs of entities with *ordered* cones.

A copy of the JAX package's ``fem/plex.py`` without the static-analysis
markers.

A mesh topology is a set of entities (cells, edges, vertices; "DAG points")
with, per entity, an ordered *cone* — the list of directly-attached entities
of one dimension lower (§2.1, [Lange et al. 2016]).  Cone order is the
structure the whole paper leans on: it is preserved by distribution and by
save/load, so DoF orderings derived from cones are save/load-stable while
global numbers and local numbers are not.

``Plex`` is the monolithic (global-numbering) topology used to *construct*
test problems; all distributed algorithms operate on per-rank ``LocalPlex``
objects and never consult the global object (mirroring the paper's fully
distributed setting — the global numbering ``I`` exists, the global *object*
does not).

CSR layout
----------
Both mesh classes store cones in compressed-sparse-row form: two flat arrays
``cone_offsets`` ([E + 1]) and ``cone_indices`` ([nnz]), where the cone of
entity ``p`` is ``cone_indices[cone_offsets[p]:cone_offsets[p + 1]]`` in
order.  Every traversal (transitive closure, overlap growth, ownership
resolution) is an iterated *vectorised* gather over these arrays — a
frontier-based BFS whose per-round work is one ``ragged_arange`` gather plus
one ``np.unique`` — so no per-entity Python runs anywhere on the hot path,
the same replicated-vs-distributed bottleneck removal as "Fully Parallel Mesh
I/O using PETSc DMPlex" [Hapla et al. 2021].  ``cones`` remains available as
a thin list-compatible read view (:class:`CSRCones`) for tests and reference
code that index one entity at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.comm import Comm, ragged_arange, rank_radix, split_segments
from repro_torch.core.star_forest import StarForest, partition_rank_of, partition_starts

_INT = np.int64


# ============================================================= CSR machinery
class CSRCones:
    """List-compatible read view over CSR cones: ``view[p]`` is the ordered
    cone of entity ``p`` (a slice of ``indices`` — no copies)."""

    __slots__ = ("offsets", "indices")

    def __init__(self, offsets: np.ndarray, indices: np.ndarray):
        self.offsets = offsets
        self.indices = indices

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, p: int) -> np.ndarray:
        return self.indices[self.offsets[int(p)]:self.offsets[int(p) + 1]]

    def __iter__(self):
        for p in range(len(self)):
            yield self[p]


def csr_offsets(sizes: np.ndarray) -> np.ndarray:
    """Offsets array ([0, cumsum(sizes)]) for a CSR segmentation."""
    return np.concatenate([[0], np.cumsum(sizes)]).astype(_INT)


def csr_from_cone_list(cones: Sequence[np.ndarray]
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of per-entity cone arrays into (offsets, indices)."""
    sizes = np.array([len(c) for c in cones], dtype=_INT)
    indices = (np.concatenate([np.asarray(c, dtype=_INT) for c in cones])
               if len(cones) else np.empty(0, _INT))
    return csr_offsets(sizes), indices.astype(_INT, copy=False)


def _as_id_array(ids) -> np.ndarray:
    """Normalise an id collection (ndarray / sequence / set) to an int64
    array WITHOUT per-element Python: set inputs go through ``np.fromiter``
    (one C loop), never ``sorted`` (per-element compares on the save hot
    loop); callers needing sorted-unique ids apply ``np.unique``."""
    if isinstance(ids, (set, frozenset)):
        return np.fromiter(ids, dtype=_INT, count=len(ids))
    return np.asarray(ids, dtype=_INT)


def in_sorted(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Vectorised membership of ``values`` in a *sorted unique* ``table``."""
    values = np.asarray(values, dtype=_INT)
    if len(table) == 0:
        return np.zeros(values.shape, dtype=bool)
    pos = np.minimum(np.searchsorted(table, values), len(table) - 1)
    return table[pos] == values


def csr_closure(offsets: np.ndarray, indices: np.ndarray,
                seeds: np.ndarray) -> np.ndarray:
    """Transitive cone closure over a CSR graph (includes seeds), returned as
    sorted unique indices.  Frontier BFS: each round gathers the cones of the
    frontier in one ``ragged_arange`` fancy-index and keeps the unseen part —
    O(edges) total, no per-entity Python."""
    seen = np.unique(np.asarray(seeds, dtype=_INT))
    frontier = seen
    while frontier.size:
        cnt = offsets[frontier + 1] - offsets[frontier]
        nxt = np.unique(indices[ragged_arange(offsets[frontier], cnt)])
        frontier = nxt[~in_sorted(nxt, seen)]
        seen = np.union1d(seen, frontier)
    return seen


def csr_closure_pairs(offsets: np.ndarray, indices: np.ndarray,
                      tags: np.ndarray, seeds: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Tagged transitive closure: unique (tag, point) pairs with ``point``
    reachable from the seed carrying ``tag`` (seeds included).  The pair
    frontier is deduplicated per round with a 2-column ``np.unique`` — never
    a packed ``tag * E + point`` scalar key, which would overflow int64
    beyond ~3e9 entities (the paper's 8.2B-DoF scale)."""
    tags = np.asarray(tags, dtype=_INT)
    seeds = np.asarray(seeds, dtype=_INT)
    seen = np.unique(np.stack([tags, seeds], axis=1), axis=0)
    frontier = seen
    while len(frontier):
        t, p = frontier[:, 0], frontier[:, 1]
        cnt = offsets[p + 1] - offsets[p]
        cand = np.stack([np.repeat(t, cnt),
                         indices[ragged_arange(offsets[p], cnt)]], axis=1)
        both = np.concatenate([seen, cand])
        # np.unique(return_index=True) is stable (mergesort): a pair already
        # in ``seen`` keeps a first-occurrence index < len(seen)
        uniq, first = np.unique(both, axis=0, return_index=True)
        frontier = uniq[first >= len(seen)]
        seen = uniq
    return seen[:, 0], seen[:, 1]


def csr_closure_pairs_packed(offsets: np.ndarray, indices: np.ndarray,
                             seeds: np.ndarray, tags: np.ndarray | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Self-tagged transitive closure over *positions*: unique
    (seed position, reachable position) pairs, seeds included, sorted by
    (seed, point).  The fused all-ranks variant of
    :func:`csr_closure_pairs` used by the flat load engine: because tag and
    point are both positions into ONE in-memory array of length ``n``,
    packing the pair into the scalar key ``tag * n + point`` cannot overflow
    int64 (n² < 2**63 for any addressable n) — unlike global-id tags, where
    ``tag * E`` overflows at the paper's multi-billion-entity scale and the
    2-column unique of :func:`csr_closure_pairs` is required.

    With ``tags`` (aligned to ``seeds``) the closure is tagged by those
    values instead of the seed positions — the rank-tagged mode of the flat
    save engine.  Packing stays safe because tags are *ranks*: the rank
    count is bounded (checked below), unlike id×id keys."""
    n = len(offsets) - 1
    seeds = np.asarray(seeds, dtype=_INT)
    nn = np.int64(max(n, 1))
    if tags is None:
        # unconditional (survives python -O): a wrapped key silently pairs
        # the wrong (seed, point) positions
        if n > 0 and n > np.iinfo(np.int64).max // n:
            raise ValueError(
                f"position-key packing overflows int64 for n={n}")
        tags = seeds
    else:
        tags = np.asarray(tags, dtype=_INT)
        tmax = int(tags.max()) if tags.size else 0
        if n > 0 and tmax > 0 and tmax >= np.iinfo(np.int64).max // nn:
            raise ValueError(
                f"(tag, position) key packing overflows int64 for "
                f"max tag {tmax}, n={n}")
    if seeds.size == 0:
        return np.empty(0, _INT), np.empty(0, _INT)
    # id-scale product is safe: both factors are bounded by the overflow
    # guards above (positions < n, or radix-checked rank tags)
    seen = np.unique(tags * nn + seeds)  # ckptlint: disable=CKPT004
    frontier = seen
    while frontier.size:
        t, p = frontier // nn, frontier % nn
        cnt = offsets[p + 1] - offsets[p]
        cand = (np.repeat(t, cnt) * nn
                + indices[ragged_arange(offsets[p], cnt)])
        nxt = np.unique(cand)
        frontier = nxt[~in_sorted(nxt, seen)]
        seen = np.union1d(seen, frontier)
    return seen // nn, seen % nn


# =============================================================== global mesh
@dataclasses.dataclass
class Plex:
    """Monolithic mesh topology in global numbering (test-construction only).

    Cones are CSR (``cone_offsets``/``cone_indices``); ``cones`` is a
    list-compatible view.
    """

    dim: int                       # topological dimension
    dims: np.ndarray               # [E] dimension of each entity
    cone_offsets: np.ndarray       # [E + 1]
    cone_indices: np.ndarray       # [nnz] ordered global ids (dim-1 entities)
    vertex_start: int              # vertices are entities [vertex_start, E)
    coords: np.ndarray             # [nvertices, gdim]

    @classmethod
    def from_cone_list(cls, dim: int, dims: np.ndarray,
                       cones: Sequence[np.ndarray], vertex_start: int,
                       coords: np.ndarray) -> "Plex":
        off, idx = csr_from_cone_list(cones)
        return cls(dim, dims, off, idx, vertex_start, coords)

    @property
    def cones(self) -> CSRCones:
        return CSRCones(self.cone_offsets, self.cone_indices)

    @property
    def num_entities(self) -> int:
        return len(self.dims)

    @property
    def cell_ids(self) -> np.ndarray:
        return np.flatnonzero(self.dims == self.dim).astype(_INT)

    def vertex_coord(self, g: int) -> np.ndarray:
        return self.coords[g - self.vertex_start]

    def closure(self, seeds) -> np.ndarray:
        """Transitive cone closure (includes seeds), sorted unique."""
        seeds = _as_id_array(seeds)
        if seeds.size == 0:
            return np.empty(0, _INT)
        return csr_closure(self.cone_offsets, self.cone_indices, seeds)

    def vertex_cell_incidence(self) -> tuple[np.ndarray, np.ndarray]:
        """All (vertex, incident cell) pairs, lexicographically sorted by
        vertex — the adjacency for overlap growth, as two flat arrays.
        Memoised: ``distribute`` queries it once per rank, and the topology
        of a ``Plex`` is immutable by convention (test construction only)."""
        cached = getattr(self, "_vci_cache", None)
        if cached is not None:
            return cached
        cells = self.cell_ids
        tags, pts = csr_closure_pairs(self.cone_offsets, self.cone_indices,
                                      cells, cells)
        m = self.dims[pts] == 0
        v, c = pts[m], tags[m]
        order = np.lexsort((c, v))
        self._vci_cache = (v[order], c[order])
        return self._vci_cache

    def incidence_csr(self) -> tuple[np.ndarray, np.ndarray,
                                     np.ndarray, np.ndarray]:
        """Both directions of :meth:`vertex_cell_incidence` as CSR over the
        full entity id space: ``(cell→vertex offsets, indices,
        vertex→cell offsets, indices)``.  The adjacency the rank-flat
        overlap growth gathers through; memoised like the pair list."""
        cached = getattr(self, "_inc_csr_cache", None)
        if cached is not None:
            return cached
        v, c = self.vertex_cell_incidence()      # sorted by (v, c)
        E = self.num_entities
        vc_off = csr_offsets(np.bincount(v, minlength=E))
        corder = np.lexsort((v, c))
        cv_off = csr_offsets(np.bincount(c, minlength=E))
        self._inc_csr_cache = (cv_off, v[corder], vc_off, c)
        return self._inc_csr_cache


# ---------------------------------------------------------------- mesh makers
def interval_mesh(ncells: int, *, seed: int | None = None) -> Plex:
    """1-D mesh of the unit interval.  Entities: cells [0, nc), vertices
    [nc, 2nc+1).  With ``seed``, cone orders are randomly flipped — valid
    meshes whose DoF orderings must still round-trip (Fig. 2.3 stress test).
    """
    nc = int(ncells)
    E = nc + nc + 1
    dims = np.zeros(E, dtype=_INT)
    dims[:nc] = 1
    rng = np.random.default_rng(seed) if seed is not None else None
    cones: list[np.ndarray] = []
    for c in range(nc):
        pair = [nc + c, nc + c + 1]
        if rng is not None and rng.integers(2):
            pair = pair[::-1]
        cones.append(np.array(pair, dtype=_INT))
    cones += [np.empty(0, dtype=_INT)] * (nc + 1)
    coords = np.linspace(0.0, 1.0, nc + 1)[:, None]
    return Plex.from_cone_list(1, dims, cones, vertex_start=nc, coords=coords)


def tri_mesh(nx: int, ny: int, *, seed: int | None = None) -> Plex:
    """Unit-square triangulation (each grid quad split along its diagonal).

    Entities numbered cells, then edges, then vertices.  With ``seed``,
    cell cones are randomly rotated and edge cones randomly flipped.

    The entity numbering and the per-entity rng draw *sequence* are part of
    the on-disk fixtures' provenance (tests/data) — this maker must stay
    bit-deterministic.  For large benchmark meshes use :func:`tri_mesh_fast`.
    """
    rng = np.random.default_rng(seed) if seed is not None else None
    nvx, nvy = nx + 1, ny + 1
    vid = lambda i, j: i * nvy + j           # grid index -> vertex index
    ncells = 2 * nx * ny

    # enumerate unique edges as sorted vertex pairs
    tris = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            tris.append((v00, v10, v11))
            tris.append((v00, v11, v01))
    edge_index: dict[tuple[int, int], int] = {}
    tri_edges = []
    for (a, b, c) in tris:
        es = []
        for (u, v) in ((a, b), (b, c), (c, a)):
            key = (min(u, v), max(u, v))
            if key not in edge_index:
                edge_index[key] = len(edge_index)
            es.append(edge_index[key])
        tri_edges.append(es)
    nedges = len(edge_index)
    nverts = nvx * nvy

    E = ncells + nedges + nverts
    dims = np.concatenate([
        np.full(ncells, 2), np.full(nedges, 1), np.full(nverts, 0)
    ]).astype(_INT)
    edge_g = lambda e: ncells + e
    vert_g = lambda v: ncells + nedges + v

    cones: list[np.ndarray] = []
    for t, es in enumerate(tri_edges):
        order = list(range(3))
        if rng is not None:
            order = list(np.roll(order, int(rng.integers(3))))
        cones.append(np.array([edge_g(es[k]) for k in order], dtype=_INT))
    edge_pairs = sorted(edge_index.items(), key=lambda kv: kv[1])
    for (u, v), _ in edge_pairs:
        pair = [vert_g(u), vert_g(v)]
        if rng is not None and rng.integers(2):
            pair = pair[::-1]
        cones.append(np.array(pair, dtype=_INT))
    cones += [np.empty(0, dtype=_INT)] * nverts

    coords = np.array([[i / nx, j / ny] for i in range(nvx) for j in range(nvy)])
    return Plex.from_cone_list(2, dims, cones,
                               vertex_start=ncells + nedges, coords=coords)


def tri_mesh_fast(nx: int, ny: int) -> Plex:
    """Fully vectorised unit-square triangulation for large benchmark meshes
    (~10⁵ entities in milliseconds).  Same entity *classes* and numbering
    scheme as :func:`tri_mesh` (cells, then edges, then vertices) but edges
    are enumerated analytically, not by traversal order, so the two makers
    are not interchangeable where fixtures pin exact ids."""
    nvy = ny + 1
    ncells = 2 * nx * ny
    # grid vertex ids of each quad, vectorised over (i, j)
    ii, jj = np.meshgrid(np.arange(nx, dtype=_INT),
                         np.arange(ny, dtype=_INT), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    v00 = ii * nvy + jj
    v10 = (ii + 1) * nvy + jj
    v01 = ii * nvy + jj + 1
    v11 = (ii + 1) * nvy + jj + 1
    # tris interleaved like tri_mesh: (v00,v10,v11), then (v00,v11,v01)
    tri_v = np.empty((ncells, 3), dtype=_INT)
    tri_v[0::2] = np.stack([v00, v10, v11], axis=1)
    tri_v[1::2] = np.stack([v00, v11, v01], axis=1)
    # unique edges as sorted vertex pairs, one cone row per tri edge
    raw = np.stack([tri_v, np.roll(tri_v, -1, axis=1)], axis=2)  # [nc,3,2]
    raw = np.sort(raw.reshape(-1, 2), axis=1)
    edges, tri_e = np.unique(raw, axis=0, return_inverse=True)
    nedges = len(edges)
    nverts = (nx + 1) * nvy
    E = ncells + nedges + nverts
    dims = np.concatenate([np.full(ncells, 2, dtype=_INT),
                           np.full(nedges, 1, dtype=_INT),
                           np.zeros(nverts, dtype=_INT)])
    cone_sizes = np.concatenate([np.full(ncells, 3, dtype=_INT),
                                 np.full(nedges, 2, dtype=_INT),
                                 np.zeros(nverts, dtype=_INT)])
    offsets = csr_offsets(cone_sizes)
    indices = np.concatenate([
        ncells + tri_e.reshape(ncells, 3).reshape(-1),
        ncells + nedges + edges.reshape(-1),
    ]).astype(_INT)
    gx, gy = np.meshgrid(np.arange(nx + 1) / nx, np.arange(nvy) / ny,
                         indexing="ij")
    coords = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
    return Plex(2, dims, offsets, indices,
                vertex_start=ncells + nedges, coords=coords)


# ================================================================ local mesh
@dataclasses.dataclass
class LocalPlex:
    """Per-rank view of a distributed topology (local numbering).

    ``loc_g`` is the paper's LocG array; ``owner[i]`` is the owning rank of
    local entity ``i`` (== this rank iff owned); cones are CSR in local
    numbers with order preserved from the global mesh.  ``global_to_local``
    resolves global ids through a lazily-built sorted index map — the
    vectorised replacement for the old per-rank ``g2l`` dicts.
    """

    dim: int
    dims: np.ndarray                 # [El]
    cone_offsets: np.ndarray         # [El + 1]
    cone_indices: np.ndarray         # [nnz] local ids
    loc_g: np.ndarray                # [El] global ids (LocG)
    owner: np.ndarray                # [El] owning rank
    rank: int
    vcoords: np.ndarray | None = None  # [El, gdim]; valid rows where dims==0

    def __post_init__(self):
        self._g_sorted = None        # built on first global_to_local call
        self._g_perm = None

    @property
    def cones(self) -> CSRCones:
        return CSRCones(self.cone_offsets, self.cone_indices)

    @property
    def num_entities(self) -> int:
        return len(self.dims)

    @property
    def owned(self) -> np.ndarray:
        return self.owner == self.rank

    @property
    def cell_ids_local(self) -> np.ndarray:
        return np.flatnonzero(self.dims == self.dim).astype(_INT)

    def global_to_local(self, g: np.ndarray) -> np.ndarray:
        """Vectorised global→local id resolution (every ``g`` must be
        present).  O(n log n) searchsorted through the sorted LocG copy."""
        if self._g_sorted is None:
            self._g_perm = np.argsort(self.loc_g).astype(_INT)
            self._g_sorted = self.loc_g[self._g_perm]
        g = np.asarray(g, dtype=_INT)
        pos = np.minimum(np.searchsorted(self._g_sorted, g),
                         max(len(self._g_sorted) - 1, 0))
        if g.size and (len(self._g_sorted) == 0
                       or not (self._g_sorted[pos] == g).all()):
            miss = (g if len(self._g_sorted) == 0
                    else g[self._g_sorted[pos] != g])
            raise ValueError(
                f"global_to_local: global id {int(miss[0])} not present "
                f"on rank {self.rank}")
        return self._g_perm[pos]

    def closure_local(self, seeds) -> np.ndarray:
        seeds = _as_id_array(seeds)
        if seeds.size == 0:
            return np.empty(0, _INT)
        return csr_closure(self.cone_offsets, self.cone_indices, seeds)


def _local_order(ids: np.ndarray, dims_of_ids: np.ndarray) -> np.ndarray:
    """Deterministic local numbering: cells first, then faces/edges, then
    vertices; within a dimension by ascending global number.  Determinism is
    what makes the same-count reload path (§3.1 end) reproduce local layouts
    exactly.  ``dims_of_ids`` is aligned to ``ids`` (one dim per id)."""
    order = np.lexsort((ids, -np.asarray(dims_of_ids, dtype=_INT)))
    return np.asarray(ids, dtype=_INT)[order]


def build_local_plex(plex: Plex, visible_cells, entity_owner: np.ndarray,
                     rank: int) -> LocalPlex:
    vis = plex.closure(visible_cells)                 # sorted unique globals
    if vis.size == 0:
        gdim = plex.coords.shape[1]
        return LocalPlex(plex.dim, np.empty(0, _INT), np.zeros(1, _INT),
                         np.empty(0, _INT), np.empty(0, _INT),
                         np.empty(0, _INT), rank, np.empty((0, gdim)))
    loc_g = _local_order(vis, plex.dims[vis])
    # local index of each position in the sorted ``vis`` array
    local_of_pos = np.empty(len(vis), dtype=_INT)
    local_of_pos[np.searchsorted(vis, loc_g)] = np.arange(len(vis), dtype=_INT)
    sizes = plex.cone_offsets[loc_g + 1] - plex.cone_offsets[loc_g]
    flat_glob = plex.cone_indices[ragged_arange(plex.cone_offsets[loc_g],
                                                sizes)]
    cone_indices = local_of_pos[np.searchsorted(vis, flat_glob)]
    cone_offsets = csr_offsets(sizes)
    dims_l = plex.dims[loc_g]
    owner = entity_owner[loc_g].astype(_INT)
    vcoords = np.full((len(loc_g), plex.coords.shape[1]), np.nan)
    vmask = dims_l == 0
    vcoords[vmask] = plex.coords[loc_g[vmask] - plex.vertex_start]
    return LocalPlex(plex.dim, dims_l, cone_offsets, cone_indices, loc_g,
                     owner, rank, vcoords)


def cell_partition(ncells: int, nranks: int, method: str = "contiguous",
                   seed: int = 0) -> np.ndarray:
    """Assign cells to ranks.  'contiguous' mimics a band partitioner;
    'random' is the adversarial stress case; 'stripes' is round-robin."""
    if method == "contiguous":
        return partition_rank_of(np.arange(ncells), ncells, nranks)
    if method == "stripes":
        return (np.arange(ncells) % nranks).astype(_INT)
    if method == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, nranks, size=ncells).astype(_INT)
    raise ValueError(method)


def entity_owners(plex: Plex, cell_owner: np.ndarray) -> np.ndarray:
    """Ownership rule: an entity is owned by the minimum rank among owners of
    cells whose closure contains it (one owner per entity; others see ghosts).
    One tagged closure over the whole mesh + one scatter-min."""
    cells = plex.cell_ids
    owner = np.full(plex.num_entities, np.iinfo(np.int64).max, dtype=_INT)
    if cells.size == 0:
        return owner
    tags, pts = csr_closure_pairs(plex.cone_offsets, plex.cone_indices,
                                  cells, cells)
    np.minimum.at(owner, pts, np.asarray(cell_owner, dtype=_INT)[tags])
    return owner


def add_overlap(plex: Plex, visible_cells, layers: int) -> np.ndarray:
    """Add ``layers`` layers of vertex-adjacent neighbour cells (§2.1.2:
    'a single layer of neighboring cells and the lower dimensional entities
    directly attached to them').  Returns sorted unique cell ids.

    Single-rank reference path; ``distribute`` runs the rank-flat
    :func:`overlap_all_ranks` instead."""
    vis = np.unique(_as_id_array(visible_cells))
    if layers == 0 or vis.size == 0:
        return vis
    inc_v, inc_c = plex.vertex_cell_incidence()
    for _ in range(layers):
        cl = plex.closure(vis)
        verts = cl[plex.dims[cl] == 0]
        lo = np.searchsorted(inc_v, verts, side="left")
        hi = np.searchsorted(inc_v, verts, side="right")
        vis = np.union1d(vis, inc_c[ragged_arange(lo, hi - lo)])
    return vis


def _rank_radix(nranks: int, E: int) -> np.int64:
    """Packing radix for (rank, global id) scalar keys — the shared guard
    lives in :func:`repro_torch.core.comm.rank_radix`; ``rank * (E + 1) + id``
    fits int64 because rank counts are bounded, where id×id keys would
    not."""
    return rank_radix(nranks, E + 1)


def overlap_all_ranks(plex: Plex, vis_rank: np.ndarray, vis_cell: np.ndarray,
                      nranks: int, layers: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """:func:`add_overlap` for EVERY rank at once: grow ``layers`` layers of
    vertex-adjacent neighbour cells around the flat rank-tagged visible-cell
    set ``(vis_rank[i], vis_cell[i])``.  Per layer, two CSR gathers over the
    memoised cell↔vertex incidence — (rank, cell) → (rank, vertex) →
    (rank, cell) — on ``rank * (E + 1) + id`` packed keys; no per-rank
    Python anywhere.  Returns the grown pairs sorted unique by (rank, cell).
    """
    radix = _rank_radix(nranks, plex.num_entities)
    key = np.unique(np.asarray(vis_rank, dtype=_INT) * radix
                    + np.asarray(vis_cell, dtype=_INT))
    if layers == 0 or key.size == 0:
        return key // radix, key % radix
    cv_off, cv_idx, vc_off, vc_idx = plex.incidence_csr()
    for _ in range(layers):
        r, c = key // radix, key % radix
        # vertices in the closure of each rank's visible cells
        cnt = cv_off[c + 1] - cv_off[c]
        vk = np.unique(np.repeat(r, cnt) * radix
                       + cv_idx[ragged_arange(cv_off[c], cnt)])
        v_rank, v_ids = vk // radix, vk % radix
        # every cell incident to those vertices joins the rank's set
        cnt2 = vc_off[v_ids + 1] - vc_off[v_ids]
        ck = np.unique(np.repeat(v_rank, cnt2) * radix
                       + vc_idx[ragged_arange(vc_off[v_ids], cnt2)])
        key = np.union1d(key, ck)
    return key // radix, key % radix


def build_local_plexes(plex: Plex, vis_rank: np.ndarray, vis_cell: np.ndarray,
                       entity_owner: np.ndarray, nranks: int
                       ) -> list[LocalPlex]:
    """:func:`build_local_plex` for EVERY rank at once — the save-side
    analogue of the loader's batched ``_build_locals``.

    One rank-tagged transitive closure (``csr_closure_pairs_packed`` with
    rank tags) yields all ranks' visible entity sets; ONE lexsort orders
    every fragment into the deterministic local numbering (cells, faces,
    vertices; ascending global id within a dimension) and one ragged gather
    localises every cone.  The returned :class:`LocalPlex` arrays are
    disjoint views of the flat buffers (``split_segments``, never
    ``np.split``)."""
    gdim = plex.coords.shape[1]
    rank_tags, ids = csr_closure_pairs_packed(
        plex.cone_offsets, plex.cone_indices,
        np.asarray(vis_cell, dtype=_INT),
        tags=np.asarray(vis_rank, dtype=_INT))
    radix = _rank_radix(nranks, plex.num_entities)
    n = len(ids)
    counts = np.bincount(rank_tags, minlength=nranks).astype(_INT)
    bases = csr_offsets(counts)
    dims_all = plex.dims[ids]
    # deterministic local numbering, all ranks in one lexsort
    perm = np.lexsort((ids, -dims_all, rank_tags))
    inv = np.empty(n, dtype=_INT)
    inv[perm] = np.arange(n, dtype=_INT)
    ids_p = ids[perm]
    rank_p = rank_tags[perm]               # == rank_tags (perm is rank-major)
    dims_p = dims_all[perm]
    # cones of every entity in local order, localised via the sorted
    # (rank, id) key table of the closure output
    sz_p = (plex.cone_offsets[ids_p + 1] - plex.cone_offsets[ids_p]
            ).astype(_INT)
    flat_glob = plex.cone_indices[ragged_arange(plex.cone_offsets[ids_p],
                                                sz_p)]
    key_table = rank_tags * radix + ids    # ascending (closure is sorted)
    pos_sorted = np.searchsorted(key_table,
                                 np.repeat(rank_p, sz_p) * radix + flat_glob)
    nnz_r = np.bincount(rank_p, weights=sz_p, minlength=nranks).astype(_INT)
    cone_local = inv[pos_sorted] - np.repeat(bases[:-1], nnz_r)
    co = csr_offsets(sz_p)
    # per-rank offset arrays (each n_r + 1 long, rebased to 0), built flat
    co_idx = ragged_arange(bases[:-1], counts + 1)
    co_local = co[co_idx] - np.repeat(co[bases[:-1]], counts + 1)
    vcoords = np.full((n, gdim), np.nan)
    vmask = dims_p == 0
    vcoords[vmask] = plex.coords[ids_p[vmask] - plex.vertex_start]
    loc_g_v = split_segments(ids_p, counts)
    dims_v = split_segments(dims_p, counts)
    offs_v = split_segments(co_local, counts + 1)
    cones_v = split_segments(cone_local, nnz_r)
    owner_v = split_segments(entity_owner[ids_p].astype(_INT), counts)
    vc_v = split_segments(vcoords, counts)
    return [LocalPlex(plex.dim, dims_v[r], offs_v[r], cones_v[r], loc_g_v[r],
                      owner_v[r], r, vc_v[r]) for r in range(nranks)]


def distribute(plex: Plex, nranks: int, *, method: str = "contiguous",
               seed: int = 0, overlap: int = 1,
               cell_owner: np.ndarray | None = None
               ) -> tuple[list[LocalPlex], StarForest, np.ndarray]:
    """Distribute a global mesh over ``nranks``.

    Returns (local plexes, pointSF, cell_owner).  The pointSF maps each
    rank-local entity (leaf) to the owning rank's local copy (root) — the
    DMPlex pointSF of §3.1.

    Rank-flat: overlap growth, the local builds and the pointSF each run as
    ONE vectorised pass over all ranks' flat rank-tagged arrays (the save-
    side counterpart of the loader's ``TopoForest`` engine) — per-rank
    outputs are bit-identical to the per-rank ``add_overlap`` /
    ``build_local_plex`` formulation, locked by ``tests/test_save_engine``.
    """
    cells = plex.cell_ids
    if cell_owner is None:
        cell_owner = cell_partition(len(cells), nranks, method, seed)
    owner = entity_owners(plex, cell_owner)
    # rank-major visible-cell pairs: stable sort keeps ids ascending per rank
    order = np.argsort(cell_owner, kind="stable")
    vis_rank = np.asarray(cell_owner, dtype=_INT)[order]
    vis_cell = cells[order]
    if overlap:
        vis_rank, vis_cell = overlap_all_ranks(plex, vis_rank, vis_cell,
                                               nranks, overlap)
    locals_ = build_local_plexes(plex, vis_rank, vis_cell, owner, nranks)
    sf = point_sf(locals_)
    return locals_, sf, cell_owner


def point_sf(locals_: list[LocalPlex]) -> StarForest:
    """Build the pointSF: leaf (r, i) -> (owner rank, owner-local index).

    One global sort over all ranks' (rank, global id) keys builds the
    owner-local index table; one searchsorted resolves every leaf — no
    per-neighbour mask loops or per-owner ``global_to_local`` probes at any
    rank count.  The per-rank attachment arrays are disjoint views of two
    flat buffers."""
    nranks = len(locals_)
    sizes = np.asarray([lp.num_entities for lp in locals_], dtype=_INT)
    loc_g = (np.concatenate([lp.loc_g for lp in locals_])
             if nranks else np.empty(0, _INT))
    owner = (np.concatenate([lp.owner for lp in locals_]).astype(_INT)
             if nranks else np.empty(0, _INT))
    E = int(loc_g.max(initial=-1)) + 1
    radix = _rank_radix(nranks, E)
    rank_rep = np.repeat(np.arange(nranks, dtype=_INT), sizes)
    bases = csr_offsets(sizes)
    # (holder rank, global id) -> holder-local index, one sorted table
    tab_key = rank_rep * radix + loc_g
    torder = np.argsort(tab_key)
    tab_sorted = tab_key[torder]
    tab_local = (np.arange(len(loc_g), dtype=_INT)
                 - np.repeat(bases[:-1], sizes))[torder]
    want = owner * radix + loc_g
    pos = np.minimum(np.searchsorted(tab_sorted, want),
                     max(len(tab_sorted) - 1, 0))
    # loud under -O: a miss means an entity's owner lacks a copy of it
    if want.size and not (tab_sorted[pos] == want).all():
        bad = int(np.flatnonzero(tab_sorted[pos] != want)[0])
        raise ValueError(
            f"point_sf: owner rank {int(owner[bad])} holds no copy of "
            f"global id {int(loc_g[bad])}")
    nroots = tuple(int(s) for s in sizes)
    return StarForest(nroots, tuple(split_segments(owner, sizes)),
                      tuple(split_segments(tab_local[pos], sizes)))


# ---------------------------------------------------- distributed directory
# Generic machinery lives in repro_torch.core.directory; re-exported here because
# the pointSF construction of §3.1 is its canonical use.
from repro_torch.core.directory import (  # noqa: E402,F401
    build_location_sf,
    location_directory,
    location_query,
)
