"""Meshes for the port: rule tables, DTensor placements, the ghost rule's
box math (``sharding``, a copy of the reference's) and the collectives
through which one process, rank 0, drives the checkpoint engine for all."""

from repro_torch.distrib.context import (MeshContext, mesh_context,
                                         shard_hint, use_mesh_context)
from repro_torch.distrib.rules import RuleTable, placements_for, rules_for
