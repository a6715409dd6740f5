"""Distributed location directory over the canonical partition (pivot L_P).

A copy of the JAX package's ``core/directory.py``.

Generic machinery shared by the FE path (pointSF construction, Appendix B)
and the tensor path (in-memory resharding): owners publish
``global number -> (rank, local index)`` onto the canonical partition of the
global number space; any rank resolves arbitrary global numbers through it.
No rank ever holds the full mapping — the paper's "collective metadata"
discipline.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.comm import Comm, split_segments
from repro_torch.core.star_forest import StarForest

_INT = np.int64

Directory = tuple[list[np.ndarray], list[np.ndarray]]


def location_directory(loc_g_list: list[np.ndarray], owned_list: list[np.ndarray],
                       total: int, comm: Comm) -> Directory:
    """Publish (global number -> owner (rank, local index)) onto the canonical
    partition of ``{0..total-1}``.  Unpublished numbers hold -1.

    Fully flat: the per-rank LocG/owned arrays are concatenated once, the
    publish SF is built from the flat owned ids, and the two reduces run on
    rank-tagged flat views — no per-rank array work at any rank count."""
    M = len(loc_g_list)
    sizes = np.asarray([len(g) for g in loc_g_list], dtype=_INT)
    cat_g = (np.concatenate([np.asarray(g, dtype=_INT) for g in loc_g_list])
             if M else np.empty(0, _INT))
    cat_own = (np.concatenate([np.asarray(o, dtype=bool)
                               for o in owned_list])
               if M else np.empty(0, bool))
    owned_pos = np.flatnonzero(cat_own)
    owned_g_flat = cat_g[owned_pos]
    rank_rep = np.repeat(np.arange(M, dtype=_INT), sizes)
    owned_rank = rank_rep[owned_pos]
    owned_counts = np.bincount(owned_rank, minlength=M)
    leaf_bases = np.concatenate([[0], np.cumsum(sizes)]).astype(_INT)
    # local index of each published copy on its own rank
    owned_idx = owned_pos - leaf_bases[owned_rank]
    pub = StarForest.from_flat_global_numbers(owned_g_flat, owned_counts,
                                              total, M)
    owner_rank = pub.reduce(split_segments(owned_rank, owned_counts),
                            "replace", fill=-1)
    owner_idx = pub.reduce(split_segments(owned_idx, owned_counts),
                           "replace", fill=-1)
    comm.stats.record(int(owned_rank.nbytes) * 2, 0)
    return owner_rank, owner_idx


def location_query(directory: Directory, query_globals: list[np.ndarray],
                   total: int, comm: Comm, root_sizes: Sequence[int]
                   ) -> StarForest:
    """Resolve global numbers through the directory into an SF:
    leaf (r, i) -> owner's (rank, local index).  ``root_sizes`` are the
    owner-side local sizes (one allgathered integer per rank)."""
    owner_rank, owner_idx = directory
    M = len(query_globals)
    sizes = [len(g) for g in query_globals]
    cat_q = (np.concatenate([np.asarray(g, dtype=_INT)
                             for g in query_globals])
             if M else np.empty(0, _INT))
    qry = StarForest.from_flat_global_numbers(cat_q, sizes, total, M)
    rr = qry.bcast(owner_rank)
    ri = qry.bcast(owner_idx)
    comm.stats.record(sum(a.nbytes for a in rr) * 2, 0)
    return StarForest(tuple(int(s) for s in root_sizes), tuple(rr), tuple(ri))


def build_location_sf(loc_g_list: list[np.ndarray], owned_list: list[np.ndarray],
                      total: int, comm: Comm) -> StarForest:
    """Every (rank, local) copy of a global number -> its owner's copy."""
    directory = location_directory(loc_g_list, owned_list, total, comm)
    return location_query(directory, loc_g_list, total, comm,
                          [len(g) for g in loc_g_list])
