"""The paper's finite-element N-to-M checkpointing, as the port carries it.

Copies of the JAX package's ``repro.fem`` modules (NumPy code that never
imported JAX), without the static-analysis markers: DMPlex-style DAG meshes
with ordered cones (``plex``), nodal finite elements with cone-derived DoF
orderings and orientation permutations (``element``, §4), PetscSection
analogues (``section``), functions (``function``), and the full
save/load/broadcast pipeline of §2–§3 (``checkpoint``).  ``torch_fem`` is
the port's own bridge that moves DoF vectors to and from the card.
"""

from repro_torch.fem.plex import (Plex, LocalPlex, distribute, interval_mesh,
                                  tri_mesh, tri_mesh_fast)
from repro_torch.fem.element import Element
from repro_torch.fem.section import FunctionSpace
from repro_torch.fem.function import Function, interpolate, node_points
from repro_torch.fem.checkpoint import FEMCheckpoint

__all__ = [
    "Plex", "LocalPlex", "distribute", "interval_mesh", "tri_mesh",
    "tri_mesh_fast",
    "Element", "FunctionSpace", "Function", "interpolate", "node_points",
    "FEMCheckpoint",
]
