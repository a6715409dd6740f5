"""PetscSection analogue: discrete function space data (§2.2).

A copy of the JAX package's ``fem/section.py``.

A :class:`FunctionSpace` on a :class:`~repro_torch.fem.plex.LocalPlex` carries the
*local* discrete function space data — the arrays LocDOF (DoFs per entity) and
LocOFF (offset of each entity's first DoF in the local vector), indexed by
local entity number, plus the LocG array inherited from the plex (§2.2.2).

Entity traversal order is the local numbering order (the paper: "any entity
traversal order can be used"); DoFs on one entity are contiguous, ordered
canonically relative to the entity's cone (``repro_torch.fem.element``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fem.element import Element
from repro_torch.fem.plex import LocalPlex

_INT = np.int64


@dataclasses.dataclass
class FunctionSpace:
    plex: LocalPlex
    element: Element
    bs: int = 1                       # components per node (vector-valued)

    loc_dof: np.ndarray = dataclasses.field(init=False)   # [El]
    loc_off: np.ndarray = dataclasses.field(init=False)   # [El]
    ndof_local: int = dataclasses.field(init=False)

    def __post_init__(self):
        if self.element.dim != self.plex.dim:
            raise ValueError(
                f"element cell dim {self.element.dim} != mesh dim "
                f"{self.plex.dim}")
        # nodes-per-entity depends only on entity dimension: one small table
        # lookup instead of a per-entity Python call
        table = np.array([self.element.nodes_per_entity_dim(d)
                          for d in range(self.plex.dim + 1)], dtype=_INT)
        nodes = table[self.plex.dims] if len(self.plex.dims) \
            else np.empty(0, _INT)
        self.loc_dof = nodes * self.bs
        self.loc_off = np.concatenate([[0], np.cumsum(self.loc_dof)[:-1]]).astype(_INT)
        self.ndof_local = int(self.loc_dof.sum())

    # ------------------------------------------------------------- owned view
    @property
    def owned_entities(self) -> np.ndarray:
        return np.flatnonzero(self.plex.owned).astype(_INT)

    @property
    def ndof_owned(self) -> int:
        return int(self.loc_dof[self.plex.owned].sum())

    def owned_dof_mask(self) -> np.ndarray:
        """Boolean mask over the local vector marking owned DoFs.  Entity
        chunks are contiguous (``loc_off`` is the cumsum of ``loc_dof``), so
        the mask is one ``repeat`` of the owned flags."""
        return np.repeat(self.plex.owned, self.loc_dof)

    def entity_of_dof(self) -> np.ndarray:
        """Local entity index owning each local DoF slot (one ``repeat``)."""
        return np.repeat(np.arange(self.plex.num_entities, dtype=_INT),
                         self.loc_dof)

    def dof_indices(self) -> np.ndarray:
        """Positions ``[loc_off[i], loc_off[i] + loc_dof[i])`` concatenated in
        entity order — the identity lift; useful as ``ragged_arange`` input
        validation and in tests."""
        from repro_torch.core.comm import ragged_arange
        return ragged_arange(self.loc_off, self.loc_dof)
