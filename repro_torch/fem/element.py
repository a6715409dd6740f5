"""Nodal finite elements with cone-derived entity-local DoF orderings (§2.2, §4).

A copy of the JAX package's ``fem/element.py``.

The paper's contract: if multiple DoFs live on an entity, their order within
the entity's contiguous chunk of the local vector must be derivable *from the
cone of that entity alone* (Fig. 2.3, Fig. 2.5), because cones — unlike global
numbers or local numbers — are preserved by the save/load cycle.

We implement Lagrange families:
  * P (CG) and DP (DG) on intervals, degrees 0–8;
  * P (CG) and DP (DG) on triangles, degrees 0–8.

For each entity the element yields its interpolation nodes in canonical
(cone-derived) order; §4's *orientation* machinery (edge orientation in {0,1},
triangle orientation in the dihedral group of order 6) and the associated DoF
permutations are provided for mapping physical entities to the reference cell.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

_INT = np.int64


@dataclasses.dataclass(frozen=True)
class Element:
    family: str     # "P" (continuous Lagrange) | "DP" (discontinuous)
    degree: int
    cell: str       # "interval" | "triangle"

    def __post_init__(self):
        if self.family not in ("P", "DP"):
            raise ValueError(f"Element: unknown family {self.family!r} "
                             f"(want 'P' or 'DP')")
        if self.cell not in ("interval", "triangle"):
            raise ValueError(f"Element: unknown cell {self.cell!r} "
                             f"(want 'interval' or 'triangle')")
        if not 0 <= self.degree <= 8:
            raise ValueError(f"Element: degree {self.degree} out of the "
                             f"supported range [0, 8]")
        if self.family == "P" and self.degree < 1:
            raise ValueError(f"Element: P{self.degree} is not continuous; "
                             f"use DP{self.degree}")

    @property
    def dim(self) -> int:
        return {"interval": 1, "triangle": 2}[self.cell]

    # ------------------------------------------------------ DoF counts (§2.2)
    def nodes_per_entity_dim(self, d: int) -> int:
        """Number of interpolation nodes on an entity of dimension ``d``."""
        k = self.degree
        if self.family == "DP":
            if d < self.dim:
                return 0
            if self.cell == "interval":
                return k + 1
            return (k + 1) * (k + 2) // 2
        # continuous P
        if d == 0:
            return 1
        if d == 1 and self.dim >= 1:
            return max(k - 1, 0) if self.dim > 1 or self.cell == "interval" else 0
        if d == self.dim:
            if self.cell == "interval":
                return max(k - 1, 0)
            return max((k - 1) * (k - 2) // 2, 0)
        return 0

    # ------------------------------------- canonical interior lattice (tri)
    def _tri_interior_bary(self) -> list[tuple[int, int, int]]:
        """Interior lattice multi-indices (a,b,c), a+b+c=k, all >=1, in
        lexicographic order — the canonical order relative to the cone-derived
        vertex sequence (v0,v1,v2).  For P4: (1,1,2), (1,2,1), (2,1,1)."""
        k = self.degree
        return sorted((a, b, k - a - b)
                      for a in range(1, k) for b in range(1, k - a)
                      if k - a - b >= 1)

    def _tri_all_bary(self) -> list[tuple[int, int, int]]:
        k = self.degree
        if k == 0:
            return [(0, 0, 0)]  # centroid sentinel, weight handled below
        return sorted((a, b, k - a - b)
                      for a in range(0, k + 1) for b in range(0, k + 1 - a))

    # ---------------------------------------------------------- node points
    def entity_nodes_1d(self, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
        """Interior nodes of an edge/interval-cell whose cone is (v(p0), v(p1)),
        walking from cone[0] to cone[1] — Fig. 2.3's deterministic rule.

        Batched: ``p0``/``p1`` of shape (gdim,) give (k, gdim); leading batch
        dims broadcast, so (m, gdim) gives (m, k, gdim).
        """
        k = self.degree
        if self.family == "DP":
            if k == 0:
                return (p0 + p1)[..., None, :] / 2
            t = np.arange(0, k + 1) / k
        else:
            t = np.arange(1, k) / k
        return (p0[..., None, :] * (1 - t[:, None])
                + p1[..., None, :] * t[:, None])

    def cell_nodes_tri(self, v: np.ndarray) -> np.ndarray:
        """Interior (P) or all (DP) nodes of a triangle with cone-derived
        vertex positions ``v`` of shape (3, gdim) — or batched (m, 3, gdim),
        giving (m, k, gdim) via one broadcast matmul."""
        k = self.degree
        if self.family == "DP":
            if k == 0:
                return v.mean(axis=-2, keepdims=True)
            bary = np.array(self._tri_all_bary(), dtype=np.float64) / k
        else:
            if k < 3:
                return np.empty(v.shape[:-2] + (0, v.shape[-1]))
            bary = np.array(self._tri_interior_bary(), dtype=np.float64) / k
        return bary @ v


# ================================================================= §4 machinery
# Reference cones.  FIAT-style reference triangle with vertices (0,1,2),
# edges e0=(1,2), e1=(0,2), e2=(0,1); cell cone (e0,e1,e2).
REF_TRI_VERTICES = (0, 1, 2)


def edge_orientation(cone: tuple[int, int], ref: tuple[int, int]) -> int:
    """0 if the physical edge cone agrees with the reference edge cone under
    the vertex identification, 1 if reversed (two orientations per edge)."""
    if tuple(cone) == tuple(ref):
        return 0
    assert tuple(cone) == tuple(ref[::-1])
    return 1


def edge_node_permutation(nnodes: int, orientation: int) -> np.ndarray:
    """DoF permutation for an edge with ``nnodes`` interior nodes (Fig. 4.1:
    orientation 0 -> identity, orientation 1 -> reversal [2,1,0])."""
    idx = np.arange(nnodes, dtype=_INT)
    return idx if orientation == 0 else idx[::-1].copy()


_TRI_PERMS = list(itertools.permutations((0, 1, 2)))  # 6 dihedral elements


def triangle_orientation(vertex_seq: tuple[int, int, int],
                         ref_seq: tuple[int, int, int]) -> int:
    """Orientation integer in {0..5}: the index of the permutation π with
    ``vertex_seq[i] == ref_seq[π[i]]`` (member of the dihedral group, §3.1)."""
    lookup = {v: i for i, v in enumerate(ref_seq)}
    pi = tuple(lookup[v] for v in vertex_seq)
    return _TRI_PERMS.index(pi)


def triangle_interior_permutation(element: Element, orientation: int) -> np.ndarray:
    """Permutation of the cell-interior DoFs of a triangle under orientation.

    node j of the oriented cell = node perm[j] of the reference cell.  Derived
    by permuting barycentric multi-indices with the dihedral element — this is
    the FIAT/FInAT permutation table of §4 computed on the fly.
    """
    bary = element._tri_interior_bary()
    if not bary:
        return np.empty(0, dtype=_INT)
    pi = _TRI_PERMS[orientation]
    inv = [0, 0, 0]
    for i, p in enumerate(pi):
        inv[p] = i
    index = {b: i for i, b in enumerate(bary)}
    perm = np.empty(len(bary), dtype=_INT)
    for j, b in enumerate(bary):
        permuted = tuple(b[inv[i]] for i in range(3))
        perm[j] = index[permuted]
    return perm


def cone_vertex_sequences(local_plex, cells: np.ndarray) -> np.ndarray:
    """Canonical vertex sequences of many cells at once, derived from cones
    only (hence save/load-stable) — one batched CSR gather, no per-cell
    Python.  Interval: the cone itself.  Triangle with cone (e0, e1, e2):
    v0 = e0[0], v1 = e0[1], v2 = the vertex of e1 not on e0.
    Returns shape (len(cells), dim + 1)."""
    cells = np.asarray(cells, dtype=_INT)
    off, idx = local_plex.cone_offsets, local_plex.cone_indices
    if local_plex.dim == 1:
        return np.stack([idx[off[cells]], idx[off[cells] + 1]], axis=1)
    e0 = idx[off[cells]]
    e1 = idx[off[cells] + 1]
    v0, v1 = idx[off[e0]], idx[off[e0] + 1]
    a, b = idx[off[e1]], idx[off[e1] + 1]
    v2 = np.where((a != v0) & (a != v1), a, b)
    return np.stack([v0, v1, v2], axis=1)


def cone_vertex_sequence(local_plex, cell_local: int) -> np.ndarray:
    """Single-cell convenience wrapper around :func:`cone_vertex_sequences`."""
    return cone_vertex_sequences(local_plex, np.array([cell_local]))[0]
