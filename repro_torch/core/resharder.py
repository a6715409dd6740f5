"""In-memory N-to-M resharding — the paper's loader with the filesystem
replaced by live ranks (elastic scaling without touching disk).

A copy of the JAX package's ``core/resharder.py`` without the
static-analysis markers.

The composition is identical to the checkpoint loader, but the pivot directory
is built over *entities* only (one (rank, base-offset) record per chunk, never
per element): a target rank resolves each needed chunk to its source rank and
the chunk's base position in the source's local DoF vector, then derives
element-level roots locally from the within-box row-major order (cone-derived
DoF order).  A single SF bcast then moves the data — one all-to-all, which is
also the number PetscSFBcast would issue.

Rank-flat: the target-side region walk is ONE :class:`RegionPlan` per array
(the same flat (box, chunk, element) table the tensor checkpoint loader
uses) and the source-side chunk bases come from one vectorised cumsum over
the rank-tagged size array — no ``for r in range(N)`` / ``for m in
range(M)`` numpy work anywhere.  Star forests and CommStats are
bit-identical to the per-rank formulation.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.store import np_dtype

from repro_torch.core.chunk_layout import Box, StateLayout, plan_regions
from repro_torch.core.comm import Comm, split_segments
from repro_torch.core.star_forest import StarForest
from repro_torch.core.tensor_ckpt import PerRankState

_INT = np.int64


def reshard(layout: StateLayout, source: PerRankState,
            plan: list[dict[str, list[Box]]], comm_src: Comm, comm_dst: Comm
            ) -> list[dict[str, list[np.ndarray]]]:
    """Move ``source`` (N ranks of whole chunks) onto ``plan`` (M ranks of
    arbitrary boxes).  Returns per-target-rank arrays matching the plan."""
    N, M = comm_src.nranks, comm_dst.nranks
    out: list[dict[str, list[np.ndarray]]] = [dict() for _ in range(M)]
    for spec in layout.arrays:
        grid, name = spec.grid, spec.name
        E = grid.num_chunks

        # source side: local vec = concat of owned boxes; per-chunk base —
        # chunk-major block extraction, one cumsum for every rank's bases
        src_ords = [source[r][name].ordinals if name in source[r]
                    else np.empty(0, _INT) for r in range(N)]
        src_cnt = np.asarray([len(o) for o in src_ords], dtype=_INT)
        blocks = [np.ascontiguousarray(source[int(r)][name].data[int(o)])
                  .reshape(-1)
                  for r, oo in enumerate(src_ords) for o in oo]
        sizes = np.fromiter((b.size for b in blocks), dtype=_INT,
                            count=len(blocks))
        vec_cnt = np.bincount(np.repeat(np.arange(N, dtype=_INT), src_cnt),
                              weights=sizes, minlength=N).astype(_INT)
        src_flat = (np.concatenate(blocks) if blocks
                    else np.empty(0, np_dtype(spec.dtype)))
        src_vecs = split_segments(src_flat, vec_cnt)
        # within-rank base of each chunk: global exclusive cumsum rebased to
        # the rank segment start
        cs = np.concatenate([[0], np.cumsum(sizes)]).astype(_INT)
        seg0 = cs[np.concatenate([[0], np.cumsum(src_cnt)])[:-1]]
        base_flat = cs[:-1] - np.repeat(seg0, src_cnt)
        src_base = split_segments(base_flat, src_cnt)

        # entity directory: chunk ordinal -> (source rank, base offset)
        pub = StarForest.from_global_numbers(src_ords, E, max(N, M))
        src_rank_flat = np.repeat(np.arange(N, dtype=_INT), src_cnt)
        dir_rank = pub.reduce(
            split_segments(src_rank_flat, src_cnt),
            "replace", [np.full(int(s), -1, dtype=_INT) for s in pub.nroots])
        dir_base = pub.reduce(src_base, "replace",
                              [np.full(int(s), -1, dtype=_INT)
                               for s in pub.nroots])
        comm_src.stats.record(sum(o.nbytes * 2 for o in src_ords), 0)

        # target side: ONE flat region plan; needed chunks query the directory
        regions = [plan[m].get(name, []) for m in range(M)]
        rp = plan_regions(grid, regions)
        qry = StarForest.from_flat_global_numbers(
            rp.needed_ord, rp.needed_counts, E, max(N, M))
        got_rank = qry.bcast(dir_rank, return_flat=True)
        got_base = qry.bcast(dir_base, return_flat=True)
        comm_dst.stats.record(int(got_rank.nbytes) * 2, 0)

        # element-level SF: target element -> (source rank, vec position),
        # derived from the flat intersection table in one repeat + add
        rr_flat = np.repeat(got_rank[rp.inter_pos], rp.inter_sizes)
        ri_flat = (np.repeat(got_base[rp.inter_pos], rp.inter_sizes)
                   + rp.elem_within)
        # rectangular SF: M leaf ranks, N root ranks
        sf = StarForest.from_flat_attachments(
            [len(v) for v in src_vecs], rp.elem_counts, rr_flat, ri_flat)
        vals = sf.bcast(src_vecs, return_flat=True)
        comm_dst.stats.record(int(vals.nbytes), 0)

        # scatter into the target boxes (per-box reshaped views, per rank)
        per_rank_bufs = rp.scatter_to_boxes(vals, np_dtype(spec.dtype))
        for slot, regs, bufs in zip(out, regions, per_rank_bufs):
            if regs:
                slot[name] = bufs
    return out


# ===================================================== stream-backed restarts
def restart_from_step(ckpt, step: int, plan: list[dict[str, list[Box]]],
                      comm_dst: Comm) -> list[dict[str, list[np.ndarray]]]:
    """Restart-from-step-k off disk: one committed step of a checkpoint
    stream loaded onto an arbitrary M-rank region plan.

    ``ckpt`` is a :class:`~repro_torch.core.tensor_ckpt.TensorCheckpoint` over a
    (possibly series) store; the step resolves through the series manifest
    when one exists, so M need not equal the saved N and a torn step raises
    ``ValueError`` naming the committed prefix.
    """
    return ckpt.load_state(plan, comm_dst, int(step))


def sweep_steps(ckpt, plan: list[dict[str, list[Box]]], comm_dst: Comm,
                steps: list[int] | None = None,
                arrays: list[str] | None = None):
    """Post-processing sweep: iterate committed steps of a stream on M ranks.

    Yields ``(step, per_rank_values)`` for every step in ``steps`` (default:
    all committed steps, ascending).  ``arrays`` restricts the plan to a
    subset of array names — the selective-load path for cheap analysis on a
    small M.  The plan is built once and reused across the whole sweep;
    per-step I/O is then only the step's own (non-deduped) extents.
    """
    if steps is None:
        steps = ckpt.steps()
    if arrays is not None:
        keep = frozenset(arrays)
        plan = [{n: boxes for n, boxes in p.items() if n in keep}
                for p in plan]
    for s in steps:
        yield int(s), ckpt.load_state(plan, comm_dst, int(s))
