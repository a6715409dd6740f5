"""The paper's N-to-M checkpointing pipeline for FE meshes and functions.

A copy of the JAX package's ``fem/checkpoint.py`` without the
static-analysis markers.

Save side (N ranks):
  * ``save_mesh``      — DMPlexTopologyView + DMPlexLabelsView +
                          DMPlexCoordinatesView analogues.  Topology rows are
                          routed to the canonical partition of the global
                          numbering and written contiguously (many small
                          integer datasets — the reason Topology/Labels saving
                          dominates Table 6.3).
  * ``save_function``  — DMPlexSectionView (once per space; §2.2.7) +
                          DMPlexGlobalVectorView.  Section and vector rows are
                          written in *saver concatenation order* — each rank
                          one contiguous write — with G_P recording the global
                          numbers (§2.2.3–2.2.4).  This is the bandwidth-
                          critical fast path.

Load side (M ranks, M independent of N):
  * ``load_mesh``      — the three-step reconstruction of Appendix B:
                          (1) naive canonical partition → T00,
                          (2) repartition cells → T0,
                          (3) grow overlap → T;
                          with star forests χ_{I_T00}^{L_P}, χ_{I_T0}^{I_T00},
                          χ_{I_T}^{I_T0} composed into χ_{I_T}^{L_P} (B.4).
  * ``load_function``  — χ_{I_P}^{L_P} from the loaded G_P chunks (§2.2.5),
                          χ_{I_T}^{I_P} = (χ_{I_P}^{L_P})⁻¹ ∘ χ_{I_T}^{L_P}
                          (2.17), entity→DoF lift (2.22–2.23), and the final
                          broadcast VEC_T[j_T] = VEC_P[χ(j_T)] (2.24).

Flat CSR load path
------------------
All ranks' transient topology fragments on the load side live in ONE
:class:`TopoForest`: the rank-major concatenation of per-rank
:class:`TopoCSR` fragments (sorted global ids, aligned dims, CSR cones whose
entries are **positions into the concatenated id array** — cone edges never
cross rank segments, so a closed set always resolves).  Transitive closure
of the on-disk topology (``_close_forest``), ownership resolution
(``_resolve_owners``), overlap growth (``_grow_overlap``) and the local
renumbering (``_build_locals``) each run as one frontier-based vectorised
BFS / lexsort over the forest for EVERY rank at once — O(edges) work total
and **no per-rank Python array loops anywhere on the load path**: the
companion rule to the "one plan per dataset per phase" I/O convention below.
A stage that needs per-rank outputs returns disjoint views of the flat
buffers.  Where a (rank, id) pair must become one sort key it is packed as
``rank * (E + 1) + id`` — safe because the rank count is bounded, unlike
id×id keys, which are banned repo-wide (int64 overflow at the paper's
8.2B-DoF scale).  Per-rank results — and the CommStats byte accounting —
are bit-identical to the per-rank-loop formulation (locked by
``tests/test_load_engine.py`` and ``tests/test_comm_packed.py`` against
``tests/data/commstats_seed.json``); only the Python-loop count drops from
O(ranks) to O(1), which is what takes the R = 8192 FE load to seconds.

Batched I/O convention
----------------------
All store traffic follows the **one plan per dataset per phase** rule: each
save/load phase collects every rank's segment of a dataset and issues a
single :meth:`DatasetStore.write_plan` / :meth:`DatasetStore.read_plan`
call, and the loader's transitive closure runs all ranks' BFS in lockstep
(:meth:`FEMCheckpoint._close_topologies`) so each round's frontier is ONE
scattered read per topology dataset.  This is the aggregation step of
parallel DMPlex I/O (Hapla et al., arXiv:2004.08729): store call counts per
dataset are independent of the rank count, which is what keeps the
rank-sweep benchmarks flat in R.  Dataset bytes and CommStats are identical
to the per-rank-loop formulation.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.comm import (
    Comm, edge_pack, ragged_arange, rank_radix, split_segments,
)
from repro_torch.core.star_forest import (
    StarForest,
    partition_rank_of,
    partition_segments,
    partition_starts,
)
from repro_torch.core.store import DEFAULT_SERIES, DatasetStore
from repro_torch.fem.element import Element
from repro_torch.fem.function import Function
from repro_torch.fem.plex import (
    LocalPlex,
    csr_closure,
    csr_closure_pairs,
    csr_closure_pairs_packed,
    csr_offsets,
    in_sorted,
    location_directory,
    location_query,
)
from repro_torch.fem.section import FunctionSpace

_INT = np.int64


# ===================================================================== utils
def _route_rows(comm: Comm, total: int, ids: list[np.ndarray],
                payloads: list[dict[str, np.ndarray]]
                ) -> tuple[list[np.ndarray], list[dict[str, np.ndarray]]]:
    """Route per-rank (global id, payload-row) pairs to the canonical holder
    of each id.  Returns per-rank sorted ids and payloads for the holder's
    chunk.  Payload values may be 1-D (one scalar per id) or ragged via a
    companion ``<name>__sizes`` convention handled by the caller.

    Rank-flat: one sparse exchange per dataset (ids + each payload key) over
    the ``edge_pack``-compiled edge list of the concatenated send set, and
    ONE stable sort by packed (destination, id) key on the receive side —
    no per-rank dest-pack or argsort loops at any rank count.  The edge
    list, send buffers and receive permutation are identical to the old
    per-rank formulation, so CommStats stay byte-for-byte."""
    R = comm.nranks
    keys = list(payloads[0].keys()) if payloads else []
    sizes = np.asarray([len(g) for g in ids], dtype=_INT)
    g_flat = (np.concatenate([np.asarray(g, dtype=_INT) for g in ids])
              if R else np.empty(0, _INT))
    radix = rank_radix(R, total + 1)
    src = np.repeat(np.arange(R, dtype=_INT), sizes)
    order, es, ed, ecnt = edge_pack(src, partition_rank_of(g_flat, total, R),
                                    R)
    recv_ids, offs = comm.neighbor_alltoallv(es, ed, ecnt, g_flat[order],
                                             return_flat=True)
    dcnt = np.diff(offs)
    dst_rep = np.repeat(np.arange(R, dtype=_INT), dcnt)
    rorder = np.argsort(dst_rep * radix + recv_ids, kind="stable")
    out_ids = split_segments(recv_ids[rorder], dcnt)
    out_views = {}
    for k in keys:
        p_flat = np.concatenate([np.asarray(payloads[r][k])
                                 for r in range(R)])
        got, _ = comm.neighbor_alltoallv(es, ed, ecnt, p_flat[order],
                                         return_flat=True)
        out_views[k] = split_segments(got[rorder], dcnt)
    return out_ids, [{k: out_views[k][d] for k in keys} for d in range(R)]


def chi_to_LP(loc_g_list: list[np.ndarray], total: int) -> StarForest:
    """χ_{X}^{L_P}: SF from any local numbering carrying LocG arrays to the
    canonical partition of the global numbers (2.7 / 2.12)."""
    return StarForest.from_global_numbers(loc_g_list, total, len(loc_g_list))


# ==================================================== transient CSR topology
@dataclasses.dataclass
class TopoCSR:
    """A closed per-rank topology fragment read off disk.

    ``ids`` is sorted unique global numbers; ``dims[i]`` the dimension of
    ``ids[i]``; the cone of ``ids[i]`` is
    ``cone_pos[offsets[i]:offsets[i + 1]]`` — *positions into* ``ids``
    (closure guarantees resolution), order preserved from the file.
    """

    ids: np.ndarray                # [n] sorted global ids
    dims: np.ndarray               # [n]
    offsets: np.ndarray            # [n + 1]
    cone_pos: np.ndarray           # [nnz] positions into ids

    @classmethod
    def empty(cls) -> "TopoCSR":
        return cls(np.empty(0, _INT), np.empty(0, _INT), np.zeros(1, _INT),
                   np.empty(0, _INT))

    @property
    def n(self) -> int:
        return len(self.ids)

    def positions_of(self, globals_: np.ndarray) -> np.ndarray:
        """Positions of global ids (every id must be present) — one
        searchsorted, guarded so an absent id fails loudly instead of
        aliasing an unrelated position."""
        g = np.asarray(globals_, dtype=_INT)
        pos = np.minimum(np.searchsorted(self.ids, g),
                         max(self.n - 1, 0))
        assert g.size == 0 or (self.n > 0 and (self.ids[pos] == g).all()), \
            "TopoCSR.positions_of: id not in this fragment"
        return pos

    def closure_of(self, cell_globals: np.ndarray) -> np.ndarray:
        """Sorted global ids transitively reachable from ``cell_globals``."""
        if len(cell_globals) == 0:
            return np.empty(0, _INT)
        pos = csr_closure(self.offsets, self.cone_pos,
                          self.positions_of(cell_globals))
        return self.ids[pos]

    def vertex_incidence_of(self, cell_globals: np.ndarray
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Unique (vertex global id, seed cell global id) incidence pairs of
        the tagged closure — the published rows of overlap growth."""
        if len(cell_globals) == 0:
            return np.empty(0, _INT), np.empty(0, _INT)
        tags, pts = csr_closure_pairs(self.offsets, self.cone_pos,
                                      cell_globals,
                                      self.positions_of(cell_globals))
        m = self.dims[pts] == 0
        return self.ids[pts[m]], tags[m]


# ================================================ all-ranks CSR topology forest
@dataclasses.dataclass
class TopoForest:
    """Every rank's closed topology fragment as ONE rank-tagged CSR graph.

    Positions are rank-major: rank ``m``'s fragment occupies
    ``[bases[m], bases[m + 1])`` with global ids ascending within the
    segment, and ``cone_pos`` entries point into the SAME concatenated
    position space (cone edges never cross rank segments).  Every load-side
    stage — transitive closure, ownership candidates, overlap incidence,
    local renumbering — therefore runs as one vectorised pass over these
    arrays for ALL ranks at once; per-rank :class:`TopoCSR` fragments are
    recoverable as views (:meth:`fragment`).

    ``(rank, id)`` pairs are packed into scalar int64 keys
    ``rank * (E + 1) + id`` where useful — safe because the rank count is
    bounded (M ≲ 10⁴) so ``M * (E + 1)`` stays far below 2**63 even at the
    paper's multi-billion-entity scale (asserted at construction), unlike
    id×id keys which are banned repo-wide.
    """

    E: int                         # global entity count (packed-key radix)
    bases: np.ndarray              # [M + 1] entity position base per rank
    ids: np.ndarray                # [n] global ids, ascending per segment
    dims: np.ndarray               # [n]
    offsets: np.ndarray            # [n + 1]
    cone_pos: np.ndarray           # [nnz] positions into the concat space
    rank_rep: np.ndarray           # [n] owning rank of each position

    def __post_init__(self):
        # unconditional (survives python -O): a silent key wrap would
        # resolve BFS frontiers to wrong entities with no error
        if self.nranks > 0 and \
                self.nranks > np.iinfo(np.int64).max // (self.E + 1):
            raise ValueError(
                f"TopoForest: (rank, id) key packing overflows int64 for "
                f"M={self.nranks}, E={self.E}")
        self._key = None           # lazily-built sorted (rank, id) key table

    @property
    def nranks(self) -> int:
        return len(self.bases) - 1

    @property
    def n(self) -> int:
        return len(self.ids)

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.bases)

    def positions_of(self, ranks: np.ndarray, globals_: np.ndarray
                     ) -> np.ndarray:
        """Concatenated positions of (rank, global id) pairs — one
        searchsorted over the packed key table; absent pairs fail loudly."""
        if self._key is None:
            self._key = self.rank_rep * _INT(self.E + 1) + self.ids
        key = (np.asarray(ranks, dtype=_INT) * _INT(self.E + 1)
               + np.asarray(globals_, dtype=_INT))
        pos = np.minimum(np.searchsorted(self._key, key),
                         max(self.n - 1, 0))
        if key.size and (self.n == 0 or not (self._key[pos] == key).all()):
            miss = (key if self.n == 0 else key[self._key[pos] != key])
            raise ValueError(
                f"TopoForest.positions_of: (rank {int(miss[0] // (self.E + 1))}"
                f", id {int(miss[0] % (self.E + 1))}) not in the forest")
        return pos

    def positions_of_lists(self, per_rank: Sequence[np.ndarray]
                           ) -> np.ndarray:
        """Positions of per-rank global-id lists, concatenated rank-major."""
        sizes = np.asarray([len(a) for a in per_rank], dtype=_INT)
        flat = (np.concatenate([np.asarray(a, dtype=_INT)
                                for a in per_rank])
                if len(per_rank) else np.empty(0, _INT))
        return self.positions_of(
            np.repeat(np.arange(self.nranks, dtype=_INT), sizes), flat)

    def split(self, flat: np.ndarray, counts: np.ndarray | None = None
              ) -> list[np.ndarray]:
        """Per-rank views of a rank-major concatenated array."""
        sizes = self.counts if counts is None else np.asarray(counts)
        return split_segments(flat, sizes)

    def fragment(self, m: int) -> TopoCSR:
        """Rank ``m``'s fragment as a (view-backed) :class:`TopoCSR`."""
        a, b = int(self.bases[m]), int(self.bases[m + 1])
        offs = self.offsets[a:b + 1] - self.offsets[a]
        return TopoCSR(self.ids[a:b], self.dims[a:b], offs,
                       self.cone_pos[self.offsets[a]:self.offsets[b]] - a)

    def fragments(self) -> list[TopoCSR]:
        return [self.fragment(m) for m in range(self.nranks)]


# ============================================================ loaded mesh box
@dataclasses.dataclass
class LoadedMesh:
    plexes: list[LocalPlex]
    chi_IT_LP: StarForest          # composed per Appendix B (B.4)
    point_sf: StarForest
    E: int
    dim: int
    name: str
    labels: dict[str, list[np.ndarray]]


class FEMCheckpoint:
    """CheckpointFile analogue (§5) over a :class:`DatasetStore`."""

    def __init__(self, store: DatasetStore):
        self.store = store

    # --------------------------------------------------- commit-log recovery
    def _commit_log(self) -> list[dict] | None:
        """The async commit log, or None for a purely-synchronous store
        (legacy semantics: every dataset present is assumed complete)."""
        from repro_torch.core.async_io import COMMIT_LOG_KEY
        if self.store.has_attrs(COMMIT_LOG_KEY):
            return self.store.get_attrs(COMMIT_LOG_KEY)
        return None

    def steps(self, mesh: str, fname: str) -> list[int]:
        """Committed time indices of ``fname`` on ``mesh``.  With an async
        commit log only committed saves are listed — a save torn by a crash
        is never visible; legacy sync stores report every time-indexed vec
        dataset present."""
        log = self._commit_log()
        if log is not None:
            return sorted({int(e["step"]) for e in log
                           if e.get("kind") == "func"
                           and e.get("mesh") == mesh
                           and e.get("fname") == fname
                           and e.get("step") is not None})
        prefix = f"{mesh}/func/{fname}/vec_t"
        return sorted(int(d[len(prefix):]) for d in self.store.datasets()
                      if d.startswith(prefix) and d[len(prefix):].isdigit())

    def at_step(self, step: int,
                series: str = DEFAULT_SERIES) -> "FEMCheckpoint":
        """Checkpoint view of one committed series step — the
        restart-from-step-k entry point.  ``load_mesh``/``load_function`` on
        the returned checkpoint resolve every dataset through that step's
        manifest (raising ``ValueError`` for torn/uncommitted steps), so a
        stream saved on N ranks replays any step on M ranks."""
        return FEMCheckpoint(self.store.step_view(step, series))

    # ------------------------------------------------------------- save mesh
    def save_mesh(self, name: str, plexes: list[LocalPlex], comm: Comm,
                  labels: dict[str, list[np.ndarray]] | None = None) -> None:
        st, N = self.store, comm.nranks
        owned_ids = [lp.loc_g[lp.owned] for lp in plexes]
        E = int(max((ids.max(initial=-1) for ids in owned_ids), default=-1)) + 1
        gdim = next((lp.vcoords.shape[1] for lp in plexes
                     if lp.vcoords is not None), 1)
        dim = plexes[0].dim

        # ---- topology: cones in global numbering, rows indexed by I --------
        # one CSR gather per rank: owned entities' cone slices, local → global
        cone_sz, cone_flat = [], []
        for lp in plexes:
            sel = np.flatnonzero(lp.owned)
            sz = lp.cone_offsets[sel + 1] - lp.cone_offsets[sel]
            flat = lp.cone_indices[ragged_arange(lp.cone_offsets[sel], sz)]
            cone_sz.append(sz.astype(_INT))
            cone_flat.append(lp.loc_g[flat].astype(_INT))
        dims_payload = [lp.dims[lp.owned].astype(_INT) for lp in plexes]
        owner_payload = [lp.owner[lp.owned].astype(_INT) for lp in plexes]

        ids_c, pay_c = _route_rows(
            comm, E, owned_ids,
            [{"dims": dims_payload[r], "sizes": cone_sz[r],
              "owner": owner_payload[r]} for r in range(N)],
        )
        # ragged cone payload: second routing pass keyed by repeated ids
        cone_ids = [np.repeat(owned_ids[r], cone_sz[r]) for r in range(N)]
        ids_k, pay_k = _route_rows(comm, E, cone_ids,
                                   [{"cones": cone_flat[r]} for r in range(N)])

        starts = partition_starts(E, N)
        chunk_sizes = [pay_c[r]["sizes"] for r in range(N)]
        chunk_totals = [int(s.sum()) for s in chunk_sizes]
        bases = comm.exscan_sum(chunk_totals)
        total_cones = bases[-1] + chunk_totals[-1] if N else 0

        chunk_starts = [int(s) for s in starts[:N]]
        # the routed ids must tile [0, E) exactly (one owner per global
        # number) — checked flat over the concatenation, loud under -O
        ids_cat = np.concatenate(ids_c) if N else np.empty(0, _INT)
        if not np.array_equal(ids_cat, np.arange(E, dtype=_INT)):
            raise ValueError(
                f"save_mesh: routed global ids do not tile [0, {E}) — "
                "every global number must be owned by exactly one rank")
        # rank-major global exclusive cumsum == bases[r] + within-rank offset
        sizes_cat = np.concatenate(chunk_sizes) if N else np.empty(0, _INT)
        offs_rows = split_segments(
            (np.cumsum(sizes_cat) - sizes_cat).astype(_INT),
            [len(s) for s in chunk_sizes])
        # one coalesced plan per dataset — every rank's segment in one pass.
        # staged_write = create + write_plan outside a series step; inside
        # one, the topology dedups against earlier steps (mesh rarely
        # changes: hash hit ⇒ alias, zero bytes)
        st.staged_write(f"{name}/topology/dims", E, (), "int64", chunk_starts,
                        [pay_c[r]["dims"] for r in range(N)])
        st.staged_write(f"{name}/topology/cone_sizes", E, (), "int64",
                        chunk_starts, chunk_sizes)
        st.staged_write(f"{name}/topology/cone_offsets", E + 1, (), "int64",
                        chunk_starts + [E],
                        offs_rows + [np.array([total_cones], dtype=_INT)])
        st.staged_write(f"{name}/topology/entity_owner", E, (), "int64",
                        chunk_starts, [pay_c[r]["owner"] for r in range(N)])
        st.staged_write(f"{name}/topology/cones", total_cones, (), "int64",
                        bases, [pay_k[r]["cones"] for r in range(N)])

        # ---- labels (DMLabelsView): one global-indexed row per label -------
        labels = labels or {}
        for lname, per_rank in labels.items():
            vals = [per_rank[r][plexes[r].owned].astype(_INT) for r in range(N)]
            ids_l, pay_l = _route_rows(comm, E, owned_ids,
                                       [{"v": vals[r]} for r in range(N)])
            st.staged_write(f"{name}/labels/{lname}", E, (), "int64",
                            chunk_starts, [pay_l[r]["v"] for r in range(N)])

        st.set_attrs(f"{name}/meta", {
            "E": E, "dim": dim, "gdim": gdim, "nranks_saved": N,
            "labels": sorted(labels),
        })

        # ---- coordinates: a P1 vector function, saved like any function ----
        if plexes[0].vcoords is not None:
            coord_el = Element("P", 1, "interval" if dim == 1 else "triangle")
            spaces = [FunctionSpace(lp, coord_el, bs=gdim) for lp in plexes]
            funcs = []
            for lp, sp in zip(plexes, spaces):
                vals = np.zeros(sp.ndof_local)
                vm = np.flatnonzero(lp.dims == 0)
                vals[sp.loc_off[vm][:, None] + np.arange(gdim)] = \
                    lp.vcoords[vm]
                funcs.append(Function(sp, vals))
            self.save_function(name, "__coordinates", funcs, comm)

    # --------------------------------------------------------- save function
    def _section_key(self, mesh: str, sp: FunctionSpace) -> str:
        el = sp.element
        return f"{mesh}/section/{el.family}{el.degree}_{el.cell}_bs{sp.bs}"

    def save_function(self, mesh: str, fname: str, funcs: list[Function],
                      comm: Comm, time_index: int | None = None) -> None:
        """DMPlexSectionView (first call per space) + DMPlexGlobalVectorView."""
        st, N = self.store, comm.nranks
        spaces = [f.space for f in funcs]
        key = self._section_key(mesh, spaces[0])
        E = self.store.get_attrs(f"{mesh}/meta")["E"]

        # --- global section: concatenation order, G_P records global numbers
        sel = [np.flatnonzero((sp.plex.owned) & (sp.loc_dof > 0))
               for sp in spaces]
        e_cnt = [len(s) for s in sel]
        d_cnt = [int(sp.loc_dof[s].sum()) for sp, s in zip(spaces, sel)]
        e_base = comm.exscan_sum(e_cnt)
        d_base = comm.exscan_sum(d_cnt)
        Eo = e_base[-1] + e_cnt[-1]
        D = d_base[-1] + d_cnt[-1]

        # inside a series step the section must be (re-)staged every step so
        # the step manifest aliases it — the hash dedup makes that free
        if st.pending_step is not None or not st.has_dataset(f"{key}/G"):
            dof_rows = [sp.loc_dof[s] for sp, s in zip(spaces, sel)]
            off_rows = [
                (d_base[r] + np.concatenate([[0], np.cumsum(dof_rows[r])])
                 [:len(dof_rows[r])]).astype(_INT) for r in range(N)]
            st.staged_write(f"{key}/G", Eo, (), "int64", e_base,
                            [sp.plex.loc_g[s] for sp, s in zip(spaces, sel)])
            st.staged_write(f"{key}/DOF", Eo, (), "int64", e_base, dof_rows)
            st.staged_write(f"{key}/OFF", Eo, (), "int64", e_base, off_rows)
            el = spaces[0].element
            st.set_attrs(f"{key}/meta", {
                "D": D, "Eo": Eo, "family": el.family, "degree": el.degree,
                "cell": el.cell, "bs": spaces[0].bs,
            })

        # --- global DoF vector: one contiguous write per rank (§2.2.3) ------
        if st.pending_step is not None and time_index is not None:
            raise ValueError(
                "save_function: inside a series step the store manifest "
                "carries the step index; pass time_index=None")
        suffix = "" if time_index is None else f"_t{time_index}"
        vec_name = f"{mesh}/func/{fname}/vec{suffix}"
        st.staged_write(vec_name, D, (), "float64", d_base,
                        [f.values[ragged_arange(sp.loc_off[s], sp.loc_dof[s])]
                         for f, sp, s in zip(funcs, spaces, sel)])
        st.set_attrs(f"{mesh}/func/{fname}/meta", {"section": key})

    # ------------------------------------------------------------- load mesh
    def _fetch_entities(self, name: str, ids: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Random-access read of (dims, cone sizes, flat cones) for arbitrary
        global ids — the loader's closure fetch (a parallel-filesystem read,
        like HDF5).  Cones come back as one flat global-number array,
        segmented by the returned sizes."""
        st = self.store
        dims = st.read_rows_at(f"{name}/topology/dims", ids)
        # one scattered read for both offset bounds: [id, id + 1] rows
        # interleave into longer contiguous runs than two separate fetches
        both = np.unique(np.concatenate([ids, ids + 1]))
        offs = st.read_rows_at(f"{name}/topology/cone_offsets", both)
        off0 = offs[np.searchsorted(both, ids)]
        off1 = offs[np.searchsorted(both, ids + 1)]
        sizes = (off1 - off0).astype(_INT)
        rows = ragged_arange(off0.astype(_INT), sizes)
        if rows.size:
            flat = st.read_rows_at(f"{name}/topology/cones",
                                   rows).astype(_INT)
        else:
            # closing BFS round: every frontier cone is empty — skip the
            # no-op scattered read (IOStats would not count it either, so
            # the static ckptcost certificate stays exact)
            flat = np.empty(0, _INT)
        return dims.astype(_INT), sizes, flat

    def _close_forest(self, name: str, seed_lists: Sequence[np.ndarray],
                      E: int) -> TopoForest:
        """Transitively fetch cones until closed, for ALL ranks at once,
        with NO per-rank Python anywhere.

        The BFS state is the flat set of (rank, id) pairs, packed into
        scalar keys: each round takes the union of every rank's frontier
        ids, fetches it in one batched scattered read per dataset (the
        aggregated-I/O model — duplicate ids across ranks are read once,
        like MPI-IO collective buffering), expands every pair's cones in one
        ragged gather, and keeps the unseen pairs.  Per-rank frontier
        evolution — and hence the resulting fragments — is identical to
        closing each rank separately; only the store call count (and
        duplicate traffic) shrinks.  The accumulated batches are stitched
        into the rank-major forest with a single lexsort + ragged gather."""
        M = len(seed_lists)
        sizes = np.asarray([len(s) for s in seed_lists], dtype=_INT)
        seeds_flat = (np.concatenate([np.asarray(s, dtype=_INT)
                                      for s in seed_lists])
                      if M else np.empty(0, _INT))
        radix = _INT(E + 1)
        if M > 0 and M > np.iinfo(np.int64).max // (E + 1):
            raise ValueError(f"(rank, id) key packing overflows int64 for "
                             f"M={M}, E={E}")
        f_key = np.unique(np.repeat(np.arange(M, dtype=_INT), sizes) * radix
                          + seeds_flat)
        seen_key = f_key
        b_rank, b_ids, b_dims, b_sizes, b_flat = [], [], [], [], []
        while f_key.size:
            f_rank, f_ids = f_key // radix, f_key % radix
            union = np.unique(f_ids)
            dims_u, sizes_u, flat_u = self._fetch_entities(name, union)
            off_u = csr_offsets(sizes_u)
            pos = np.searchsorted(union, f_ids)
            sz = sizes_u[pos]
            b_rank.append(f_rank)
            b_ids.append(f_ids)
            b_dims.append(dims_u[pos])
            b_sizes.append(sz)
            flat = flat_u[ragged_arange(off_u[pos], sz)]
            b_flat.append(flat)
            nxt = np.unique(np.repeat(f_rank, sz) * radix + flat)
            f_key = nxt[~in_sorted(nxt, seen_key)]
            seen_key = np.union1d(seen_key, f_key)
        if not b_rank:
            return TopoForest(E, np.zeros(M + 1, _INT), np.empty(0, _INT),
                              np.empty(0, _INT), np.zeros(1, _INT),
                              np.empty(0, _INT), np.empty(0, _INT))
        rank_cat = np.concatenate(b_rank)
        ids_cat = np.concatenate(b_ids)
        dims_cat = np.concatenate(b_dims)
        sizes_cat = np.concatenate(b_sizes)
        flat_cat = np.concatenate(b_flat)
        starts_cat = (np.cumsum(sizes_cat) - sizes_cat).astype(_INT)
        order = np.lexsort((ids_cat, rank_cat))   # pairs unique per batch
        rank_s, ids_s = rank_cat[order], ids_cat[order]
        sizes_s = sizes_cat[order]
        offsets = csr_offsets(sizes_s)
        flat_s = flat_cat[ragged_arange(starts_cat[order], sizes_s)]
        key_table = rank_s * radix + ids_s
        cone_pos = np.searchsorted(
            key_table, np.repeat(rank_s, sizes_s) * radix + flat_s
        ).astype(_INT)
        bases = csr_offsets(np.bincount(rank_s, minlength=M))
        return TopoForest(E, bases, ids_s, dims_cat[order], offsets,
                          cone_pos, rank_s)

    def _close_topologies(self, name: str,
                          seed_lists: Sequence[np.ndarray]) -> list[TopoCSR]:
        """Per-rank fragment view of :meth:`_close_forest` (reference and
        test surface; the load pipeline stays on the forest)."""
        E = int(self.store.get_attrs(f"{name}/meta")["E"])
        return self._close_forest(name, seed_lists, E).fragments()

    def _build_locals(self, forest: TopoForest, dim: int, gdim: int,
                      owner_cat: np.ndarray | None = None
                      ) -> list[LocalPlex]:
        """Reorder every rank's closed fragment into the deterministic local
        numbering (cells, faces, vertices; ascending global id within a
        dimension) in ONE batched lexsort + ragged cone gather across all
        ranks; the returned :class:`LocalPlex` arrays are disjoint views of
        the flat buffers.  ``owner_cat`` (aligned to forest positions) is
        carried through the same permutation."""
        n, M = forest.n, forest.nranks
        sizes = np.diff(forest.offsets)
        perm = np.lexsort((forest.ids, -forest.dims, forest.rank_rep))
        inv = np.empty(n, dtype=_INT)
        inv[perm] = np.arange(n, dtype=_INT)
        sizes_p = sizes[perm]
        flat_pos = forest.cone_pos[ragged_arange(forest.offsets[perm],
                                                 sizes_p)]
        ebase = forest.bases
        counts = np.diff(ebase)
        nnz_r = forest.offsets[ebase[1:]] - forest.offsets[ebase[:-1]]
        # cone targets: permuted position - rank base = local index
        cone_local = inv[flat_pos] - np.repeat(ebase[:-1], nnz_r)
        co = csr_offsets(sizes_p)
        # per-rank offset arrays (each n_r + 1 long, rebased to 0), built flat
        co_idx = ragged_arange(ebase[:-1], counts + 1)
        co_local = co[co_idx] - np.repeat(co[ebase[:-1]], counts + 1)
        loc_g_v = forest.split(forest.ids[perm])
        dims_v = forest.split(forest.dims[perm])
        offs_v = split_segments(co_local, counts + 1)
        cones_v = split_segments(cone_local, nnz_r)
        owner_v = (forest.split(owner_cat[perm])
                   if owner_cat is not None
                   else forest.split(np.full(n, -1, dtype=_INT)))
        vc_v = split_segments(np.full((n, gdim), np.nan), counts)
        return [LocalPlex(dim, dims_v[m], offs_v[m], cones_v[m], loc_g_v[m],
                          owner_v[m].astype(_INT, copy=False), m, vc_v[m])
                for m in range(M)]

    def load_mesh(self, name: str, comm: Comm, *, partition: str = "contiguous",
                  seed: int = 0, overlap: int = 1,
                  exact_distribution: bool = False) -> LoadedMesh:
        st, M = self.store, comm.nranks
        log = self._commit_log()
        if log is not None and not any(
                e.get("kind") == "mesh" and e.get("mesh") == name
                for e in log):
            raise ValueError(
                f"load_mesh: mesh '{name}' has no entry in the async commit "
                f"log — its save was interrupted before the commit marker; "
                f"the torn datasets are not loadable")
        meta = st.get_attrs(f"{name}/meta")
        E, dim, gdim = meta["E"], meta["dim"], meta["gdim"]
        starts = partition_starts(E, M)

        # ---- Step 1 (DMPlexTopologyLoad): naive canonical partition → T00 --
        chunks = split_segments(np.arange(E, dtype=_INT), np.diff(starts))
        f00 = self._close_forest(name, chunks, E)
        # T00 bookkeeping, flat: a position is "in chunk" iff its global id
        # falls in its own rank's canonical range
        in_chunk = ((f00.ids >= starts[f00.rank_rep])
                    & (f00.ids < starts[f00.rank_rep + 1]))
        cell_mask = in_chunk & (f00.dims == dim)
        cells_flat = f00.ids[cell_mask]
        cell_rank = f00.rank_rep[cell_mask]
        cell_counts = np.bincount(cell_rank, minlength=M)
        t00_cells = split_segments(cells_flat, cell_counts)
        # T00 local numbering: canonical chunk first (ascending), then ghosts
        order00 = np.lexsort((f00.ids, ~in_chunk, f00.rank_rep))
        t00_counts = f00.counts
        t00_locg_flat = f00.ids[order00]
        chi_T00_LP = StarForest.from_flat_global_numbers(
            t00_locg_flat, t00_counts, E, M)

        # ---- Step 2 (DMPlexDistribute): repartition cells → T0 -------------
        cell_bases = comm.exscan_sum([int(c) for c in cell_counts])
        ncells = (cell_bases[-1] + int(cell_counts[-1])) if M else 0
        if exact_distribution:
            nsaved = meta["nranks_saved"]
            if M != nsaved:
                raise ValueError(
                    f"exact-distribution reload needs the loading rank count "
                    f"to equal the saving one: loading on M={M} ranks, "
                    f"saved from N={nsaved}")
            owner_rows = st.read_plan(f"{name}/topology/entity_owner",
                                      *partition_segments(E, M))
            # rank-major concatenation of the canonical segments == the full
            # entity_owner table, indexable by global id (BSP-sim shortcut
            # for the per-rank chunk lookups)
            dests = np.concatenate(owner_rows)[cells_flat].astype(_INT)
        elif partition == "contiguous":
            # rank-major flat cell list == ascending global cell index
            dests = partition_rank_of(np.arange(ncells, dtype=_INT),
                                      ncells, M)
        elif partition == "random":
            dests = random_partition_dests(cells_flat, M, seed)
        else:
            raise ValueError(partition)
        # CSR-pack by (source rank, destination) and ship the sparse edges —
        # no dense R×R count matrix is ever materialised
        sorder, sek_src, sek_dst, secnt = edge_pack(cell_rank, dests, M)
        recv_flat, recv_offs = comm.neighbor_alltoallv(
            sek_src, sek_dst, secnt, cells_flat[sorder], return_flat=True)
        t0_cell_counts = np.diff(recv_offs)
        recv_rank = np.repeat(np.arange(M, dtype=_INT), t0_cell_counts)
        t0_cells = split_segments(recv_flat[np.lexsort((recv_flat,
                                                        recv_rank))],
                                  t0_cell_counts)

        f0 = self._close_forest(name, t0_cells, E)
        # order T0 local numbering like the final rule for determinism
        order0 = np.lexsort((f0.ids, -f0.dims, f0.rank_rep))
        t0_locg_flat = f0.ids[order0]
        t0_counts = f0.counts
        t0_locg = f0.split(t0_locg_flat)
        t0_owner = _resolve_owners(comm, E, t0_locg_flat, t0_counts,
                                   t0_cells, f0)
        # χ_{I_T0}^{I_T00}: root = T00 copy on the canonical rank of g
        rr_flat = partition_rank_of(t0_locg_flat, E, M)
        ri_flat = t0_locg_flat - starts[rr_flat]
        chi_T0_T00 = StarForest(tuple(int(c) for c in t00_counts),
                                tuple(f0.split(rr_flat)),
                                tuple(f0.split(ri_flat)))

        # ---- Step 3 (DMPlexDistributeOverlap): grow overlap → T ------------
        final_cells = t0_cells
        if overlap:
            final_cells = _grow_overlap(comm, E, t0_cells, f0, overlap)
        f_t = self._close_forest(name, final_cells, E)
        t_owner = _resolve_owners(comm, E, f_t.ids, f_t.counts,
                                  t0_cells, f_t)
        # owner arrays are aligned to the forest's sorted ids; the batched
        # local build carries them through its permutation
        plexes = self._build_locals(f_t, dim, gdim,
                                    owner_cat=np.concatenate(t_owner)
                                    if f_t.n else None)

        # χ_{I_T}^{I_T0}: directory over T0, queried with final LocG ---------
        t0_owner_flat = np.concatenate(t0_owner) if f0.n else np.empty(0, _INT)
        t0_owned = f0.split(t0_owner_flat
                            == np.repeat(np.arange(M, dtype=_INT), t0_counts))
        t0_dir = location_directory(t0_locg, t0_owned, E, comm)
        chi_T_T0 = location_query(t0_dir, [lp.loc_g for lp in plexes], E, comm,
                                  [len(g) for g in t0_locg])

        # ---- compose (B.4) --------------------------------------------------
        chi_IT_LP = chi_T_T0.compose(chi_T0_T00.compose(chi_T00_LP))

        point_sf = location_query(
            location_directory([lp.loc_g for lp in plexes],
                               [lp.owned for lp in plexes], E, comm),
            [lp.loc_g for lp in plexes], E, comm,
            [lp.num_entities for lp in plexes])

        # ---- labels ---------------------------------------------------------
        labels = {}
        for lname in meta.get("labels", []):
            lchunks = st.read_plan(f"{name}/labels/{lname}",
                                   *partition_segments(E, M))
            labels[lname] = chi_IT_LP.bcast(lchunks)

        mesh = LoadedMesh(plexes, chi_IT_LP, point_sf, E, dim, name, labels)

        # ---- coordinates (a P1 function, loaded like any function) ---------
        if st.has_attrs(f"{name}/func/__coordinates/meta"):
            spaces, funcs = self.load_function(mesh, "__coordinates", comm)
            for lp, sp, f in zip(plexes, spaces, funcs):
                vm = np.flatnonzero(lp.dims == 0)
                lp.vcoords[vm] = f.values[sp.loc_off[vm][:, None]
                                          + np.arange(sp.bs)]
        return mesh

    # --------------------------------------------------------- load function
    def load_function(self, mesh: LoadedMesh, fname: str, comm: Comm,
                      time_index: int | None = None
                      ) -> tuple[list[FunctionSpace], list[Function]]:
        st, M = self.store, comm.nranks
        # coordinates ride on the mesh's own commit entry (load_mesh checks)
        log = self._commit_log()
        if log is not None and fname != "__coordinates":
            committed = [e.get("step") for e in log
                         if e.get("kind") == "func"
                         and e.get("mesh") == mesh.name
                         and e.get("fname") == fname]
            if time_index not in committed:
                raise ValueError(
                    f"load_function: '{fname}' time_index {time_index} is "
                    f"not committed (committed: {sorted(s for s in committed if s is not None)}) "
                    f"— a crash mid-write leaves the torn save invisible")
        fmeta = st.get_attrs(f"{mesh.name}/func/{fname}/meta")
        key = fmeta["section"]
        smeta = st.get_attrs(f"{key}/meta")
        D, Eo = smeta["D"], smeta["Eo"]
        element = Element(smeta["family"], smeta["degree"], smeta["cell"])
        bs = smeta["bs"]
        E = mesh.E

        spaces = [FunctionSpace(lp, element, bs=bs) for lp in mesh.plexes]

        # ---- §2.2.5: load section chunks, build χ_{I_P}^{L_P} --------------
        ea, en = partition_segments(Eo, M)
        locG_P = [a.astype(_INT) for a in st.read_plan(f"{key}/G", ea, en)]
        locDOF_P = [a.astype(_INT) for a in st.read_plan(f"{key}/DOF", ea, en)]
        locOFF_P = [a.astype(_INT) for a in st.read_plan(f"{key}/OFF", ea, en)]
        chi_IP_LP = chi_to_LP(locG_P, E)

        # ---- (2.17): χ_{I_T}^{I_P} = (χ_{I_P}^{L_P})⁻¹ ∘ χ_{I_T}^{L_P} ------
        chi_IT_IP = mesh.chi_IT_LP.compose(chi_IP_LP.invert(allow_partial=True))

        # ---- (2.18): broadcast DOF and OFF onto the loaded topology --------
        DOF_T = chi_IT_IP.bcast(locDOF_P)
        OFFg_T = chi_IT_IP.bcast(locOFF_P)
        for sp, dof in zip(spaces, DOF_T):
            if not np.array_equal(dof, sp.loc_dof):
                raise ValueError(
                    f"section/element mismatch between saved and loaded "
                    f"space for '{fname}': saved per-entity DoF counts "
                    f"disagree with {sp.element.family}{sp.element.degree} "
                    f"bs={sp.bs}")

        # ---- (2.22–2.23): lift to DoF level — one ragged_arange per rank ---
        dof_globals = [ragged_arange(offg, sp.loc_dof)
                       for sp, offg in zip(spaces, OFFg_T)]
        chi_JT_JP = StarForest.from_global_numbers(dof_globals, D, M)

        # ---- (2.24): broadcast the vector ----------------------------------
        suffix = "" if time_index is None else f"_t{time_index}"
        locVEC_P = st.read_plan(f"{mesh.name}/func/{fname}/vec{suffix}",
                                *partition_segments(D, M))
        VEC_T = chi_JT_JP.bcast(locVEC_P)
        funcs = [Function(sp, v) for sp, v in zip(spaces, VEC_T)]
        return spaces, funcs


# ============================================================ loader helpers
def random_partition_dests(cell_globals: np.ndarray, nranks: int,
                           seed: int) -> np.ndarray:
    """Pseudo-random repartition destinations for the adversarial load path:
    a Knuth-multiplicative hash of the global cell number, mixed in uint64.

    The arithmetic MUST be unsigned: int64 products ``g * 2654435761``
    silently wrap once ``g`` reaches ~3.5e9 (paper-scale entity counts) and
    raise RuntimeWarning under ``np.errstate(over='raise')``; uint64 wraps
    are the hash's defined behaviour, and the result is reduced mod
    ``nranks`` before the int64 cast so dests always land in ``[0, M)``.
    For ids small enough that int64 never wrapped, the dests are identical
    to the historical signed hash (the CommStats-locked regime)."""
    g = np.asarray(cell_globals, dtype=_INT).astype(np.uint64)
    h = g * np.uint64(2654435761) + np.uint64(int(seed) % (1 << 64))
    return (h % np.uint64(nranks)).astype(_INT)


def _resolve_owners(comm: Comm, E: int, loc_g_flat: np.ndarray,
                    loc_sizes: np.ndarray, owned_cells: list[np.ndarray],
                    forest: TopoForest) -> list[np.ndarray]:
    """Entity ownership on a (re)distributed topology: owner(e) = min rank
    among ranks owning a cell whose closure contains e.  Fully distributed:
    candidates reduce(min) onto the canonical partition, then bcast back.
    ALL ranks' candidate sets come from one CSR closure over the forest;
    the query numbering comes in flat (``loc_g_flat`` rank-major with
    ``loc_sizes`` per-rank counts — what every caller already holds) and
    the returned per-rank arrays (aligned to it) are views of one flat
    buffer."""
    M = comm.nranks
    cand_pos = csr_closure(forest.offsets, forest.cone_pos,
                           forest.positions_of_lists(owned_cells))
    cand_ids = forest.ids[cand_pos]
    cand_rank = forest.rank_rep[cand_pos]
    cand_counts = np.bincount(cand_rank, minlength=M)
    pub = StarForest.from_flat_global_numbers(cand_ids, cand_counts, E, M)
    owner_glob = pub.reduce(split_segments(cand_rank, cand_counts),
                            "min", dtype=_INT,
                            fill=np.iinfo(np.int64).max)
    comm.stats.record(int(cand_rank.nbytes), 0)
    qry = StarForest.from_flat_global_numbers(loc_g_flat, loc_sizes, E, M)
    out = qry.bcast(owner_glob)
    comm.stats.record(sum(a.nbytes for a in out), 0)
    return out


def _grow_overlap(comm: Comm, E: int, owned_cells: list[np.ndarray],
                  forest: TopoForest, layers: int) -> list[np.ndarray]:
    """Single-layer vertex-adjacency overlap growth (DMPlexDistributeOverlap;
    §2.1.2: 'a single layer of neighboring cells') via a distributed
    vertex→cells directory: one alltoallv publish, one query, one answer —
    each compiled to its sparse edge list straight from flat rank-tagged
    arrays.  The (vertex, cell) incidence publish for EVERY rank is one
    position-tagged CSR closure over the forest; nothing iterates ranks."""
    if layers != 1:
        raise ValueError(
            f"the loader grows one overlap layer, as in the paper; "
            f"got layers={layers}")
    M = comm.nranks
    radix = _INT(E + 1)
    # ---- publish (vertex -> cell) incidences of owned cells, all ranks ----
    tags, pts = csr_closure_pairs_packed(
        forest.offsets, forest.cone_pos,
        forest.positions_of_lists(owned_cells))
    vm = forest.dims[pts] == 0
    v_pt, v_tag = pts[vm], tags[vm]
    pub_v = forest.ids[v_pt]           # vertex global id
    pub_c = forest.ids[v_tag]          # seed cell global id
    pub_src = forest.rank_rep[v_pt]    # publishing rank (== rank of v_tag)
    order, e_src, e_dst, ecnt = edge_pack(pub_src,
                                          partition_rank_of(pub_v, E, M), M)
    rv, rv_offs = comm.neighbor_alltoallv(e_src, e_dst, ecnt,
                                          pub_v[order], return_flat=True)
    rc, _ = comm.neighbor_alltoallv(e_src, e_dst, ecnt,
                                    pub_c[order], return_flat=True)
    # directory (per canonical rank): sorted unique (vertex, cell)
    # incidences.  3-column unique over (rank, vertex, cell) — the vertex
    # and cell columns stay unpacked, since a v*E+c key would overflow int64
    # beyond ~3e9 entities (the paper's 8.2B-DoF scale); the rank column is
    # the only packed-safe axis.
    dir_rep = np.repeat(np.arange(M, dtype=_INT), np.diff(rv_offs))
    trip = np.unique(np.stack([dir_rep, rv, rc], axis=1), axis=0)
    dir_rank, dir_v, dir_c = trip[:, 0], trip[:, 1], trip[:, 2]
    dir_key = dir_rank * radix + dir_v  # non-decreasing (trip is lexsorted)
    # ---- query: my vertices -> all incident cells anywhere ---------------
    qk = np.unique(pub_src * radix + pub_v)
    q_src, q_v = qk // radix, qk % radix
    q_dst = partition_rank_of(q_v, E, M)
    qkey = q_src * _INT(M) + q_dst     # already non-decreasing in (src, v)
    qek, qecnt = np.unique(qkey, return_counts=True)
    rq, rq_offs = comm.neighbor_alltoallv(qek // M, qek % M, qecnt, q_v,
                                          return_flat=True)
    # ---- answer: per querying rank, the sorted-unique incident cells -----
    qe_order = np.lexsort((qek // M, qek % M))     # receive side: (dst, src)
    src_of_q = np.repeat((qek // M)[qe_order], qecnt[qe_order])
    rq_rank = np.repeat(np.arange(M, dtype=_INT), np.diff(rq_offs))
    lo = np.searchsorted(dir_key, rq_rank * radix + rq, side="left")
    hi = np.searchsorted(dir_key, rq_rank * radix + rq, side="right")
    cells = dir_c[ragged_arange(lo, hi - lo)]
    atrip = np.unique(np.stack([np.repeat(rq_rank, hi - lo),
                                np.repeat(src_of_q, hi - lo),
                                cells], axis=1), axis=0)
    akey = atrip[:, 0] * _INT(M) + atrip[:, 1]
    aek, aecnt = np.unique(akey, return_counts=True)
    back, back_offs = comm.neighbor_alltoallv(aek // M, aek % M, aecnt,
                                              atrip[:, 2], return_flat=True)
    # ---- final per-rank cell sets: owned ∪ received, one packed unique ---
    own_sizes = np.asarray([len(c) for c in owned_cells], dtype=_INT)
    own_flat = (np.concatenate([np.asarray(c, dtype=_INT)
                                for c in owned_cells])
                if M else np.empty(0, _INT))
    all_rank = np.concatenate([np.repeat(np.arange(M, dtype=_INT),
                                         own_sizes),
                               np.repeat(np.arange(M, dtype=_INT),
                                         np.diff(back_offs))])
    u = np.unique(all_rank * radix + np.concatenate([own_flat, back]))
    return split_segments(u % radix, np.bincount(u // radix, minlength=M))
