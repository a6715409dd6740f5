"""Functions (DoF vectors) and nodal interpolation (§2.2.1).

A copy of the JAX package's ``fem/function.py``: ``Function.values`` is a
host float64 array (``fem.torch_fem`` moves it to and from the card).

A :class:`Function` is a local DoF vector over a :class:`FunctionSpace`
(owned + ghost values, entity chunks contiguous, intra-entity order
cone-derived).  ``node_points`` reconstructs the physical interpolation point
of every DoF slot *from cones and vertex coordinates only* — this is the
ground truth used by the correctness tests: a function interpolated before
saving and reloaded on any process count must carry the same values at the
same physical points (§6.1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fem.element import cone_vertex_sequences
from repro_torch.fem.section import FunctionSpace

_INT = np.int64


@dataclasses.dataclass
class Function:
    space: FunctionSpace
    values: np.ndarray               # [ndof_local] float64

    def __post_init__(self):
        if self.values.shape != (self.space.ndof_local,):
            raise ValueError(
                f"Function: values shape {self.values.shape} does not "
                f"match the space's ({self.space.ndof_local},) local DoFs")

    def entity_values(self, i_local: int) -> np.ndarray:
        off, n = self.space.loc_off[i_local], self.space.loc_dof[i_local]
        return self.values[off:off + n]


def node_points(space: FunctionSpace) -> np.ndarray:
    """Physical coordinates of every node slot in the local vector, derived
    from cone order alone; shape [ndof_local // bs, gdim].

    Node slots are per-node: a vector-valued space (bs > 1) stores bs
    contiguous components per node; this returns one point per node.
    """
    lp, el, bs = space.plex, space.element, space.bs
    gdim = lp.vcoords.shape[1]
    nnodes = space.loc_dof // bs                       # nodes per entity
    node_off = np.concatenate([[0], np.cumsum(nnodes)]).astype(_INT)
    out = np.empty((int(node_off[-1]), gdim))
    # one batched evaluation per entity dimension; scatter by node offset so
    # any entity traversal order is honoured
    vsel = np.flatnonzero((lp.dims == 0) & (nnodes > 0))
    if vsel.size:
        out[node_off[vsel]] = lp.vcoords[vsel]
    esel = np.flatnonzero((lp.dims == 1) & (nnodes > 0))
    if esel.size:
        # edge / interval-cell: interior/DP nodes walked cone[0] -> cone[1]
        va = lp.cone_indices[lp.cone_offsets[esel]]
        vb = lp.cone_indices[lp.cone_offsets[esel] + 1]
        nodes = el.entity_nodes_1d(lp.vcoords[va], lp.vcoords[vb])
        k = nodes.shape[1]
        out[node_off[esel][:, None] + np.arange(k)] = nodes
    tsel = np.flatnonzero((lp.dims == 2) & (nnodes > 0))
    if tsel.size:
        vseq = cone_vertex_sequences(lp, tsel)          # (m, 3)
        nodes = el.cell_nodes_tri(lp.vcoords[vseq])     # (m, k, gdim)
        k = nodes.shape[1]
        out[node_off[tsel][:, None] + np.arange(k)] = nodes
    return out


def interpolate(space: FunctionSpace, fn) -> Function:
    """Interpolate ``fn(points) -> [npts, bs]`` (or [npts] for bs=1)."""
    pts = node_points(space)
    vals = np.asarray(fn(pts), dtype=np.float64)
    if space.bs == 1 and vals.ndim == 1:
        vals = vals[:, None]
    if vals.shape != (pts.shape[0], space.bs):
        raise ValueError(
            f"interpolate: fn returned shape {vals.shape}, expected "
            f"({pts.shape[0]}, {space.bs}) for {pts.shape[0]} node points "
            f"at block size {space.bs}")
    return Function(space, vals.reshape(-1))
