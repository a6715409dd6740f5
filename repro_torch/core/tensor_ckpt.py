"""N-to-M checkpointing of tensor state — the paper's algorithm as a
training-framework feature.

Save side (N ranks), per array (== per 'function space' of the paper):
  * **section** (saved once per ownership epoch; §2.2.7): three datasets in
    saver-concatenation order — G (chunk global ordinals), DOF (box volumes),
    OFF (offsets into the element stream) — §2.2.4 verbatim.
  * **vec** (per step): each rank writes its owned chunks' elements, flattened
    in global row-major order within each box, as ONE contiguous range —
    §2.2.3's bandwidth-critical path.
  * per-chunk crc32 rows alongside each vec (integrity; beyond-paper).

Load side (M ranks, arbitrary target regions — need not align with chunks):
  * read canonical section chunks -> χ_{I_P}^{L_P} (§2.2.5);
  * needed chunks -> χ_{I_T}^{I_P} = (χ_{I_P}^{L_P})⁻¹ ∘ χ_{I_T}^{L_P} (2.17);
  * broadcast DOF/OFF (2.18); lift to element level via within-box row-major
    positions (the cone-derived DoF order; 2.22–2.23);
  * broadcast vec values from the canonical vec partition (2.24).

Same-count fast path: when the target regions are exactly the chunks a rank
saved, its vec range is read back verbatim with zero index math (§3.1 end).
"""

from __future__ import annotations

import dataclasses
import hashlib
import zlib
from typing import Sequence

import numpy as np

from repro_torch.core.chunk_layout import (
    ArraySpec, Box, StateLayout, plan_regions,
)
from repro_torch.core.comm import Comm, split_segments
from repro_torch.core.star_forest import StarForest, partition_segments
from repro_torch.core.store import DatasetStore, np_dtype

_INT = np.int64


# ============================================================= save-side model
@dataclasses.dataclass
class ArrayShard:
    """One rank's holding of one array: whole chunks, keyed by ordinal."""

    ordinals: np.ndarray                     # ascending chunk ordinals
    data: dict[int, np.ndarray]              # ordinal -> box-shaped block

    def __post_init__(self):
        self.ordinals = np.asarray(self.ordinals, dtype=_INT)
        # input validation must survive python -O: a descending ordinal
        # list silently scrambles the saver-concatenation order on disk
        if not np.all(np.diff(self.ordinals) > 0):
            raise ValueError(
                f"ArrayShard: ordinals must strictly ascend, got "
                f"{self.ordinals.tolist()}")


PerRankState = list[dict[str, ArrayShard]]   # [rank][array name]


def balanced_chunk_partition(layout: StateLayout, nranks: int
                             ) -> list[dict[str, np.ndarray]]:
    """Contiguous, element-balanced assignment of all chunks (global entity
    order) to ranks — the write-balance rule (equal-size canonical partition
    of the paper, weighted by DoF count).  One vectorised pass over the
    concatenated chunk-size arrays: rank of chunk ``i`` is the first balance
    bound at or past the chunk's midpoint ``acc_i + sz_i / 2`` (identical to
    the historical per-chunk scan), resolved by one ``searchsorted``."""
    sizes = np.concatenate(
        [spec.grid.chunk_sizes(np.arange(spec.grid.num_chunks, dtype=_INT))
         for spec in layout.arrays]) if layout.arrays else np.empty(0, _INT)
    arr_of = np.repeat(np.arange(len(layout.arrays), dtype=_INT),
                       [spec.grid.num_chunks for spec in layout.arrays])
    ords = np.concatenate(
        [np.arange(spec.grid.num_chunks, dtype=_INT)
         for spec in layout.arrays]) if layout.arrays else np.empty(0, _INT)
    total = int(sizes.sum())
    # loud int64 guard (survives -O): a wrapped product would land every
    # chunk on rank 0 with no error — the historical Python-int scan could
    # not overflow, so the vectorised bounds must refuse where it would wrap
    if nranks > 0 and total > 0 and nranks > np.iinfo(np.int64).max // total:
        raise ValueError(
            f"balanced_chunk_partition: balance bounds overflow int64 for "
            f"nranks={nranks}, total={total} elements")
    bounds = (np.arange(1, nranks + 1, dtype=_INT) * total) / nranks
    mid = (np.cumsum(sizes) - sizes) + sizes / 2
    rank_of = np.minimum(np.searchsorted(bounds, mid, side="left"),
                         nranks - 1)
    # chunks arrive in (array, ordinal) order and rank_of is non-decreasing,
    # so (rank, array) groups are contiguous runs — per-group views only
    key = rank_of * len(layout.arrays) + arr_of if len(layout.arrays) \
        else np.empty(0, _INT)
    run_starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(key)) + 1, [len(key)]]
        ).astype(_INT) if len(key) else np.array([0, 0], dtype=_INT)
    out: list[dict[str, np.ndarray]] = [dict() for _ in range(nranks)]
    names = layout.names
    for a, b in zip(run_starts[:-1], run_starts[1:]):
        if a == b:
            continue
        out[int(rank_of[a])][names[int(arr_of[a])]] = \
            np.array(ords[a:b], dtype=_INT)
    return out


def shards_from_arrays(layout: StateLayout, arrays: dict[str, np.ndarray],
                       ownership: list[dict[str, np.ndarray]]) -> PerRankState:
    """Cut monolithic arrays into per-rank ArrayShards (test/sim helper)."""
    out: PerRankState = []
    for rank_own in ownership:
        rank_state: dict[str, ArrayShard] = {}
        for name, ords in rank_own.items():
            spec = layout.spec(name)
            data = {int(o):
                    arrays[name][spec.grid.chunk_box(int(o)).slices()].copy()
                    for o in ords}
            rank_state[name] = ArrayShard(ords, data)
        out.append(rank_state)
    return out


def _ownership_fingerprint(per_rank: PerRankState, name: str) -> str:
    # one digest over the concatenated (rank, ordinals) byte stream — the
    # same bytes the old per-rank update loop fed, so digests are unchanged
    blobs = [np.int64(r).tobytes()
             + (st[name].ordinals if name in st
                else np.empty(0, _INT)).tobytes()
             for r, st in enumerate(per_rank)]
    return hashlib.sha256(b"".join(blobs)).hexdigest()[:16]


# ================================================================== the file
class TensorCheckpoint:
    """CheckpointFile (§5) for tensor state over a :class:`DatasetStore`."""

    def __init__(self, store: DatasetStore):
        self.store = store

    # ---------------------------------------------------------------- layout
    def save_layout(self, layout: StateLayout, extra: dict | None = None):
        self.store.set_attrs("layout", layout.to_json())
        self.store.set_attrs("meta", {"epochs": {}, "steps": {},
                                      "extra": extra or {}})

    def layout(self) -> StateLayout:
        return StateLayout.from_json(self.store.get_attrs("layout"))

    def steps(self) -> list[int]:
        return sorted(int(s) for s in self.store.get_attrs("meta")["steps"])

    def latest_step(self) -> int | None:
        """Restart point: the last committed step, or None for a fresh
        store (a torn in-flight step is never visible — see the recovery
        contract in ``core/async_io.py``)."""
        committed = self.steps()
        return committed[-1] if committed else None

    def _read_store(self, step: int):
        """Store view for reads of ``step``: a step committed to the series
        manifest resolves through its :class:`StepView` (dedup-aliased
        extents and all); legacy single-snapshot stores read plainly."""
        st = self.store
        has = getattr(st, "has_step", None)
        if has is not None and has(step):
            return st.step_view(step)
        return st

    def _committed_epochs(self, meta: dict, step: int) -> dict:
        """The per-array epoch map of a *committed* step; a torn or unknown
        step raises ``ValueError`` (never a bare KeyError) so recovery code
        can distinguish 'not committed' from store corruption."""
        if str(step) not in meta["steps"]:
            raise ValueError(
                f"step {step} is not committed (committed steps: "
                f"{sorted(int(s) for s in meta['steps'])}) — a crash "
                f"mid-write leaves no visible trace of the torn step")
        return meta["steps"][str(step)]

    # ----------------------------------------------------------------- save
    def save_state(self, per_rank: PerRankState, comm: Comm, step: int) -> None:
        layout = self.layout()
        meta = self.store.get_attrs("meta")
        N = comm.nranks
        if len(per_rank) != N:
            raise ValueError(
                f"save_state: {len(per_rank)} rank states for a "
                f"{N}-rank communicator")
        pend = getattr(self.store, "pending_step", None)
        if pend is not None and pend[1] != int(step):
            raise ValueError(
                f"save_state(step={step}) inside open series step {pend[1]} "
                f"— the series step and the checkpoint step must agree")
        for spec in layout.arrays:
            self._save_array(spec, per_rank, comm, step, meta)
        # atomic commit: the step becomes visible only with this write
        meta["steps"][str(step)] = {
            name: meta["epochs"][name]["current"] for name in layout.names}
        self.store.set_attrs("meta", meta)

    def _save_array(self, spec: ArraySpec, per_rank: PerRankState, comm: Comm,
                    step: int, meta: dict) -> None:
        st, name = self.store, spec.name
        fp = _ownership_fingerprint(per_rank, name)
        epochs = meta["epochs"].setdefault(
            name, {"current": -1, "fingerprints": {}})
        new_epoch = epochs["fingerprints"].get(fp) is None
        if new_epoch:
            # new ownership epoch: write the section once (§2.2.7)
            epoch = epochs["current"] + 1
            epochs["fingerprints"][fp] = epoch
            epochs["current"] = epoch
            self._write_section(spec, per_rank, comm, epoch, meta)
        epoch = epochs["fingerprints"][fp]
        epochs["current"] = epoch
        sec = meta[f"section/{name}/e{epoch}"]
        d_base, e_base = sec["d_base"], sec["e_base"]

        key = f"{name}/e{epoch}"
        if not new_epoch and st.pending_step is not None:
            # the epoch fingerprint already proved the section unchanged:
            # alias its extents into this step's manifest (legacy extents
            # predating the series resolve through the plain-name fallback)
            for part in ("G", "DOF", "OFF"):
                if not st.has_dataset(f"{key}/{part}"):
                    st.stage_carry(f"{key}/{part}")

        vec = f"{key}/s{step}/vec"
        crc = f"{key}/s{step}/crc"
        # chunk-major: one block / one crc per owned chunk across ALL ranks
        # (blocks come out of per-rank dicts — the input format — but no
        # per-rank numpy pass runs; the write is one plan per dataset, with
        # per-rank rows as views of the flat concatenation)
        shards = [rs.get(name) for rs in per_rank]
        blocks = [np.ascontiguousarray(sh.data[int(o)]).reshape(-1)
                  for sh in shards if sh is not None for o in sh.ordinals]
        vec_flat = (np.concatenate(blocks) if blocks
                    else np.empty(0, dtype=np_dtype(spec.dtype)))
        crc_flat = np.fromiter((zlib.crc32(b.tobytes()) for b in blocks),
                               dtype=_INT, count=len(blocks))
        st.staged_write(vec, spec.size, (), spec.dtype, d_base,
                        split_segments(vec_flat, sec["d_cnt"]))
        st.staged_write(crc, sec["Eo"], (), "int64", e_base,
                        split_segments(crc_flat, sec["e_cnt"]))

    def _write_section(self, spec: ArraySpec, per_rank: PerRankState,
                       comm: Comm, epoch: int, meta: dict) -> None:
        st, N, name = self.store, comm.nranks, spec.name
        grid = spec.grid
        ords = [rs[name].ordinals if name in rs else np.empty(0, _INT)
                for rs in per_rank]
        e_cnt = [len(o) for o in ords]
        ords_flat = np.concatenate(ords) if N else np.empty(0, _INT)
        # chunk volumes (DOF) and offsets (OFF) for EVERY owned chunk in one
        # vectorised pass: the saver concatenation is rank-major, so the
        # global exclusive cumsum of the sizes IS d_base[rank] + local offset
        sizes_flat = grid.chunk_sizes(ords_flat)
        d_cnt = [int(s) for s in
                 np.bincount(np.repeat(np.arange(N, dtype=_INT), e_cnt),
                             weights=sizes_flat, minlength=N)]
        e_base = comm.exscan_sum(e_cnt)
        d_base = comm.exscan_sum(d_cnt)
        Eo = e_base[-1] + e_cnt[-1]
        if Eo != grid.num_chunks:
            raise ValueError(
                f"{name}: owned chunks {Eo} != grid chunks "
                f"{grid.num_chunks} (every chunk must be owned exactly "
                "once — replicas are ghosts)")
        off_flat = (np.cumsum(sizes_flat) - sizes_flat).astype(_INT)
        key = f"{name}/e{epoch}"
        st.staged_write(f"{key}/G", Eo, (), "int64", e_base, ords)
        st.staged_write(f"{key}/DOF", Eo, (), "int64", e_base,
                        split_segments(sizes_flat, e_cnt))
        st.staged_write(f"{key}/OFF", Eo, (), "int64", e_base,
                        split_segments(off_flat, e_cnt))
        meta[f"section/{name}/e{epoch}"] = {
            "Eo": Eo, "D": spec.size, "nranks": N,
            "e_base": e_base, "d_base": d_base,
            "e_cnt": e_cnt, "d_cnt": d_cnt,
            "ordinals_per_rank": [o.tolist() for o in ords],
        }

    # ----------------------------------------------------------------- load
    def load_state(self, plan: list[dict[str, list[Box]]], comm: Comm,
                   step: int) -> list[dict[str, list[np.ndarray]]]:
        """``plan[rank][array] = [target Box, ...]`` -> same structure of
        filled numpy arrays.  Regions may cut across saved chunks freely."""
        layout = self.layout()
        meta = self.store.get_attrs("meta")
        step_epochs = self._committed_epochs(meta, step)
        M = comm.nranks
        if len(plan) != M:
            raise ValueError(
                f"load_state: plan covers {len(plan)} ranks on a "
                f"{M}-rank communicator")
        out: list[dict[str, list[np.ndarray]]] = [dict() for _ in range(M)]
        st = self._read_store(step)
        for spec in layout.arrays:
            regions = [p.get(spec.name, []) for p in plan]
            if not any(regions):
                continue
            vals = self._load_array(spec, regions, comm,
                                    int(step_epochs[spec.name]), step, meta,
                                    st)
            for slot, regs, v in zip(out, regions, vals):
                if regs:
                    slot[spec.name] = v
        return out

    def _load_array(self, spec: ArraySpec, regions: list[list[Box]],
                    comm: Comm, epoch: int, step: int, meta: dict, st
                    ) -> list[list[np.ndarray]]:
        M, name = comm.nranks, spec.name
        grid = spec.grid
        sec = meta[f"section/{name}/e{epoch}"]
        Eo, D = sec["Eo"], sec["D"]
        key = f"{name}/e{epoch}"
        vec = f"{key}/s{step}/vec"

        # ---- same-count fast path (§3.1): regions == saved chunks ----------
        if M == sec["nranks"] and _plan_matches_saved(grid, regions, sec):
            per_rank_rows = st.read_plan(vec, sec["d_base"], sec["d_cnt"])
            e_cnt = np.asarray([len(o) for o in sec["ordinals_per_rank"]],
                               dtype=_INT)
            ords_flat = (np.concatenate(
                [np.asarray(o, dtype=_INT)
                 for o in sec["ordinals_per_rank"]])
                if len(e_cnt) else np.empty(0, _INT))
            cstart, cstop = grid.chunk_bounds(ords_flat)
            shapes = cstop - cstart
            csz = np.prod(shapes, axis=1, dtype=_INT)
            # within-rank row offsets: rank-major global cumsum minus d_base
            off = ((np.cumsum(csz) - csz)
                   - np.repeat(np.asarray(sec["d_base"], dtype=_INT), e_cnt))
            rank_rep = np.repeat(np.arange(M, dtype=_INT), e_cnt)
            blocks = [per_rank_rows[r][a:a + s].reshape(tuple(map(int, shp)))
                      for r, a, s, shp in zip(rank_rep, off, csz, shapes)]
            bb = np.concatenate([[0], np.cumsum(e_cnt)]).astype(_INT)
            return [blocks[a:b] for a, b in zip(bb[:-1], bb[1:])]

        # ---- general path: ONE flat region plan, no per-rank walks ---------
        rp = plan_regions(grid, regions)

        # §2.2.5: canonical section chunks -> χ_{I_P}^{L_P}.  The canonical
        # segments tile [0, Eo), so one contiguous read IS the coalesced
        # plan (same read_calls/bytes), handed around as flat buffers.
        _, en = partition_segments(Eo, M)
        locG = st.read_rows(f"{key}/G", 0, Eo).astype(_INT, copy=False)
        locDOF = st.read_rows(f"{key}/DOF", 0, Eo).astype(_INT, copy=False)
        locOFF = st.read_rows(f"{key}/OFF", 0, Eo).astype(_INT, copy=False)
        chi_IP_LP = StarForest.from_flat_global_numbers(
            locG, en, grid.num_chunks, M)

        # (2.17): χ_{I_T}^{I_P}
        chi_IT_LP = StarForest.from_flat_global_numbers(
            rp.needed_ord, rp.needed_counts, grid.num_chunks, M)
        chi_IT_IP = chi_IT_LP.compose(chi_IP_LP.invert(allow_partial=True))

        # (2.18): broadcast OFF (and DOF, for validation) — flat leaf buffers
        OFF_T = chi_IT_IP.bcast(locOFF, return_flat=True)
        DOF_T = chi_IT_IP.bcast(locDOF, return_flat=True)
        want = grid.chunk_sizes(rp.needed_ord)
        if not np.array_equal(DOF_T, want):
            nbad = int((DOF_T != want).sum())
            raise ValueError(
                f"{name}: saved chunk sizes disagree with layout for "
                f"{nbad} of {len(want)} needed chunks")

        # (2.22–2.23): element-level global ids for every target element
        dof_ids_flat = (np.repeat(OFF_T[rp.inter_pos], rp.inter_sizes)
                        + rp.elem_within)

        # (2.24): broadcast the vec through χ_{J_T}^{J_P}
        chi_JT_JP = StarForest.from_flat_global_numbers(
            dof_ids_flat, rp.elem_counts, D, M)
        locVEC = st.read_rows(vec, 0, D)   # canonical segments tile [0, D)
        vec_flat = chi_JT_JP.bcast(locVEC, return_flat=True)

        # scatter into the target region arrays (per-box reshaped views)
        return rp.scatter_to_boxes(vec_flat, np_dtype(spec.dtype))

    # ------------------------------------------------------------- integrity
    def verify_step(self, comm: Comm, step: int) -> bool:
        """Distributed integrity scan: each rank re-reads the entities in its
        canonical L_P chunk and checks the stored per-chunk crc32.  One
        coalesced read plan per dataset (section rows AND the per-chunk vec
        ranges), so store call counts stay independent of the rank count."""
        layout = self.layout()
        meta = self.store.get_attrs("meta")
        step_epochs = self._committed_epochs(meta, step)
        M = comm.nranks
        st = self._read_store(step)
        ok = True
        for spec in layout.arrays:
            epoch = int(step_epochs[spec.name])
            Eo = meta[f"section/{spec.name}/e{epoch}"]["Eo"]
            ea, en = partition_segments(Eo, M)
            dof = np.concatenate(st.read_plan(
                f"{spec.name}/e{epoch}/DOF", ea, en)).astype(_INT)
            off = np.concatenate(st.read_plan(
                f"{spec.name}/e{epoch}/OFF", ea, en)).astype(_INT)
            crc = np.concatenate(st.read_plan(
                f"{spec.name}/e{epoch}/s{step}/crc", ea, en)).astype(_INT)
            # one coalesced plan over all chunk ranges: peak memory is
            # ~2x the dataset (run buffer + per-chunk copies) — the same
            # envelope as the load path, traded for R-independent read_calls
            vals = st.read_plan(f"{spec.name}/e{epoch}/s{step}/vec",
                                off.tolist(), dof.tolist())
            got = np.fromiter(
                (zlib.crc32(np.ascontiguousarray(v).tobytes())
                 for v in vals), dtype=_INT, count=len(vals))
            if not np.array_equal(got, crc):
                ok = False
        return ok


def _plan_matches_saved(grid, regions: list[list[Box]], sec: dict) -> bool:
    """True iff every rank's target regions are exactly its saved chunks.
    Vectorised: both sides become flat rank-tagged bound arrays, each sorted
    within its rank segment by (start, stop) — one lexsort per side, no
    per-rank Box lists."""
    counts = [len(r) for r in regions]
    if counts != [len(o) for o in sec["ordinals_per_rank"]]:
        return False
    nd = len(grid.shape)
    rank_rep = np.repeat(np.arange(len(regions), dtype=_INT), counts)
    boxes = [b for regs in regions for b in regs]
    bstart = np.array([b.start for b in boxes],
                      dtype=_INT).reshape(len(boxes), nd)
    bstop = np.array([b.stop for b in boxes],
                     dtype=_INT).reshape(len(boxes), nd)
    ords = (np.concatenate([np.asarray(o, dtype=_INT)
                            for o in sec["ordinals_per_rank"]])
            if counts else np.empty(0, _INT))
    sstart, sstop = grid.chunk_bounds(ords)

    def _order(start, stop):
        ks = [stop[:, d] for d in reversed(range(nd))]
        ks += [start[:, d] for d in reversed(range(nd))]
        ks.append(rank_rep)
        return np.lexsort(ks)

    o1, o2 = _order(bstart, bstop), _order(sstart, sstop)
    return (np.array_equal(bstart[o1], sstart[o2])
            and np.array_equal(bstop[o1], sstop[o2]))
