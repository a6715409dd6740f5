"""Communication substrate for the N-to-M checkpoint algorithm.

The paper's implementation is rank-local MPI code plus PetscSF graphs.  This
container has a single real device, so "parallel" execution is simulated in a
BSP (bulk-synchronous) style: every per-rank quantity is carried as a list
indexed by rank, and each communication round is a vectorised permutation of
those lists.  The rank-local code never reads another rank's entry except
through a :class:`Comm` call — the same discipline as MPI code — so the logic
transfers unchanged to a real multi-host runtime (where ``Comm`` would be
backed by ``jax.experimental.multihost_utils`` / a filesystem, exactly as the
paper's HDF5 path is backed by a shared parallel filesystem).

The primitives come in two tiers, mirroring how PetscSF compiles star-forest
graphs into packed message plans [Zhang et al., IEEE TPDS 2022]:

  * **packed collectives** — :meth:`Comm.alltoallv_packed` (dense count
    matrix, flat per-rank buffers) and :meth:`Comm.neighbor_alltoallv`
    (CSR edge list; only nonempty src→dst pairs are ever touched).  Both
    move data with a single vectorised segment permutation and do O(edges)
    byte accounting — no R×R Python loops anywhere, which is what makes
    simulated rank counts of 64+ practical.
  * **list collectives** — the original ``send[src][dst]`` API, kept as a
    thin shim over the packed engine during migration (it still accepts
    heterogeneous per-pair dtypes, falling back to the reference path).

All methods do byte accounting: :attr:`Comm.stats` records per-round traffic
so benchmarks can report communication volume alongside wall time (the paper
reports bandwidth per phase in Tables 6.3–6.5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


_INT = np.int64


def split_segments(flat: np.ndarray, sizes) -> list[np.ndarray]:
    """Cut a rank-major concatenated array into per-rank views — plain
    slices, NOT ``np.split`` (whose axis plumbing costs two ``swapaxes``
    per piece and dominates at thousands of ranks)."""
    offs = np.concatenate([[0], np.cumsum(np.asarray(sizes, dtype=_INT))])
    return [flat[a:b] for a, b in zip(offs[:-1], offs[1:])]


def rank_radix(nranks: int, radix: int) -> np.int64:
    """Guarded packing radix for ``rank * radix + id`` scalar keys: rank
    counts are bounded, so the product fits int64 — but only checked-for
    loudly (``ValueError`` — survives ``python -O``; a wrapped key silently
    pairs the wrong (rank, id)).  ``radix`` is the exclusive upper bound of
    the id axis; every flat pipeline packing (rank, id) keys derives it
    here so the guard exists exactly once."""
    radix = max(int(radix), 1)
    if nranks > 0 and nranks > np.iinfo(np.int64).max // radix:
        raise ValueError(f"(rank, id) key packing overflows int64 for "
                         f"R={nranks}, radix={radix}")
    return _INT(radix)


def edge_pack(src: np.ndarray, dst: np.ndarray, nranks: int
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CSR-pack flat rank-tagged rows for a sparse exchange: the stable
    permutation grouping rows by ``(src, dst)`` — ascending destination,
    source order preserved within each pair — plus the strictly-sorted
    nonempty edge list :meth:`Comm.neighbor_alltoallv` consumes.  Returns
    ``(order, edge_src, edge_dst, edge_cnt)``.  This is the one packing
    every flat pipeline (load-side repartition, overlap directory, save-side
    row routing) compiles its sends through."""
    key = (np.asarray(src, dtype=_INT) * _INT(nranks)
           + np.asarray(dst, dtype=_INT))
    order = np.argsort(key, kind="stable")
    ek, ecnt = np.unique(key, return_counts=True)
    return order, (ek // nranks).astype(_INT), (ek % nranks).astype(_INT), \
        ecnt.astype(_INT)


def ragged_arange(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Concatenation of ``arange(s, s + n)`` for each (s, n) pair, fully
    vectorised — the workhorse of every CSR gather in this package."""
    starts = np.asarray(starts, dtype=_INT)
    lengths = np.asarray(lengths, dtype=_INT)
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, _INT)
    out_starts = np.cumsum(lengths) - lengths
    idx = np.arange(total, dtype=_INT)
    return idx - np.repeat(out_starts, lengths) + np.repeat(starts, lengths)


@dataclasses.dataclass
class CommStats:
    """Traffic accounting, in bytes, across all rounds so far."""

    rounds: int = 0
    bytes_moved: int = 0          # total bytes that crossed a rank boundary
    bytes_local: int = 0          # bytes "sent" rank->same rank (no wire cost)
    max_round_bytes: int = 0      # largest single round (straggler proxy)

    def record(self, moved: int, local: int) -> None:
        self.rounds += 1
        self.bytes_moved += moved
        self.bytes_local += local
        self.max_round_bytes = max(self.max_round_bytes, moved)


class Comm:
    """In-process BSP communicator over ``nranks`` simulated ranks."""

    def __init__(self, nranks: int):
        if nranks < 1:
            raise ValueError(f"Comm needs nranks >= 1, got {nranks}")
        self.nranks = int(nranks)
        self.stats = CommStats()

    # -------------------------------------------------------------- helpers
    def _account(self, per_pair_bytes: np.ndarray) -> None:
        """per_pair_bytes[src, dst] = bytes sent src->dst."""
        moved = int(per_pair_bytes.sum() - np.trace(per_pair_bytes))
        local = int(np.trace(per_pair_bytes))
        self.stats.record(moved, local)

    # ----------------------------------------------------- packed collectives
    def neighbor_alltoallv(self, src: np.ndarray, dst: np.ndarray,
                           cnt: np.ndarray,
                           send_flat: "Sequence[np.ndarray] | np.ndarray",
                           return_flat: bool = False):
        """Sparse (neighborhood) all-to-all over an explicit edge list.

        ``(src[e], dst[e], cnt[e])`` enumerates the nonempty src→dst pairs,
        sorted by ``(src, dst)``; ``send_flat[s]`` is ONE array per source
        rank — the concatenation, in ascending-destination order, of
        everything rank ``s`` sends (``cnt`` counts leading-dim rows).
        ``send_flat`` may also be a single ndarray: the full src-major
        concatenation (what a flat caller already holds), avoiding the
        per-rank list round-trip.

        Returns ``recv_flat`` with ``recv_flat[d]`` = the concatenation, in
        ascending-source order, of everything sent to ``d`` (views of one
        freshly-permuted buffer).  With ``return_flat``, returns
        ``(out_flat, offsets)`` instead — the dst-major concatenation plus
        the per-destination row offsets — so flat pipelines skip the
        per-rank split entirely.  Only the listed edges are touched: work
        and accounting are O(edges + data), never O(R²).
        """
        R = self.nranks
        src = np.asarray(src, dtype=_INT)
        dst = np.asarray(dst, dtype=_INT)
        cnt = np.asarray(cnt, dtype=_INT)
        if not (src.shape == dst.shape == cnt.shape):
            raise ValueError(f"edge arrays disagree: src {src.shape}, "
                             f"dst {dst.shape}, cnt {cnt.shape}")
        if src.size:
            key = src * R + dst
            if not (np.diff(key) > 0).all():
                raise ValueError("edges must be strictly sorted by "
                                 "(src, dst)")
        if isinstance(send_flat, np.ndarray):
            flat = send_flat
            if int(cnt.sum()) != len(flat):
                raise ValueError(f"edge counts must cover every row of "
                                 f"send_flat: sum(cnt)={int(cnt.sum())}, "
                                 f"rows={len(flat)}")
        else:
            data = [np.asarray(b) for b in send_flat]
            if len(data) != R:
                raise ValueError(f"send_flat has {len(data)} per-rank "
                                 f"buffers, expected R={R}")
            flat = np.concatenate(data) if R > 1 else data[0]
            sent_rows = np.bincount(src, weights=cnt, minlength=R
                                    ).astype(_INT)
            if not np.array_equal(sent_rows,
                                  np.array([len(d) for d in data])):
                raise ValueError("edge counts must cover every row of "
                                 "send_flat: per-source rows "
                                 f"{sent_rows.tolist()} != buffer rows "
                                 f"{[len(d) for d in data]}")
        # uniform row type across the exchange (one MPI datatype per call)
        row_nbytes = flat.itemsize * int(np.prod(flat.shape[1:], initial=1))

        wire = cnt * row_nbytes
        off_wire = src != dst
        self.stats.record(int(wire[off_wire].sum()),
                          int(wire[~off_wire].sum()))

        # permute segments from (src, dst)-major to (dst, src)-major
        in_starts = np.cumsum(cnt) - cnt
        order = np.lexsort((src, dst))
        gather = ragged_arange(in_starts[order], cnt[order])
        out_flat = flat[gather]
        per_dst = np.bincount(dst, weights=cnt, minlength=R).astype(_INT)
        offs = np.concatenate([[0], np.cumsum(per_dst)]).astype(_INT)
        if return_flat:
            return out_flat, offs
        return [out_flat[offs[d]:offs[d + 1]] for d in range(R)]

    def alltoallv_packed(self, counts: np.ndarray,
                         send_flat: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Dense-plan packed all-to-all: ``counts[s, d]`` rows go s→d.

        ``send_flat[s]`` is the ascending-destination concatenation of rank
        ``s``'s outgoing rows; the return value is the ascending-source
        concatenation per destination (segmentation = ``counts[:, d]``).
        Zero-count pairs cost nothing — the exchange is compiled down to the
        nonempty edge list and handed to :meth:`neighbor_alltoallv`.
        """
        R = self.nranks
        counts = np.asarray(counts, dtype=_INT)
        if counts.shape != (R, R):
            raise ValueError(f"counts matrix is {counts.shape}, expected "
                             f"(R, R)=({R}, {R})")
        src, dst = np.nonzero(counts)          # row-major == (src, dst) sorted
        return self.neighbor_alltoallv(src, dst, counts[src, dst], send_flat)

    # ------------------------------------------------------- list collectives
    def alltoallv(
        self, send: Sequence[Sequence[np.ndarray]]
    ) -> list[list[np.ndarray]]:
        """``send[src][dst]`` is the buffer src sends to dst (legacy API).

        Returns ``recv`` with ``recv[dst][src]`` = that buffer.  Kept as a
        thin shim over :meth:`alltoallv_packed` for callers not yet migrated;
        heterogeneous per-pair dtypes/row-shapes fall back to the reference
        list path with identical accounting.
        """
        R = self.nranks
        assert len(send) == R and all(len(s) == R for s in send)
        first = send[0][0]
        uniform = all(b.dtype == first.dtype and b.shape[1:] == first.shape[1:]
                      for row in send for b in row)
        if not uniform:
            pair = np.array([[b.nbytes for b in row] for row in send],
                            dtype=_INT)
            self._account(pair)
            # receive buffers are fresh memory, as in MPI: a receiver
            # mutating its buffer must never corrupt the sender's array
            return [[send[s][d].copy() for s in range(R)] for d in range(R)]
        counts = np.array([[len(b) for b in row] for row in send], dtype=_INT)
        flat = [np.concatenate(row) if R > 1 else row[0] for row in send]
        recv_flat = self.alltoallv_packed(counts, flat)
        splits = [np.cumsum(counts[:, d])[:-1] for d in range(R)]
        return [np.split(recv_flat[d], splits[d]) for d in range(R)]

    def allgather(self, values: Sequence[np.ndarray]) -> list[list[np.ndarray]]:
        """Every rank receives every rank's value, in a fresh buffer (a
        receiver mutating its copy must never corrupt the sender's array —
        live on the N=1/M=1 paths where src and dst are the same rank)."""
        R = self.nranks
        nbytes = np.array([v.nbytes for v in values], dtype=_INT)
        total = int(nbytes.sum())
        self.stats.record(total * (R - 1), total)
        return [[values[s].copy() for s in range(R)] for _ in range(R)]

    def allreduce_sum(self, values: Sequence[np.ndarray]) -> list[np.ndarray]:
        R = self.nranks
        total = values[0].copy()
        for v in values[1:]:
            total = total + v
        # ring all-reduce traffic model: 2*(R-1)/R of the data per rank
        per_rank = 2 * values[0].nbytes * (R - 1) // max(R, 1)
        self.stats.record(per_rank * R if R > 1 else 0,
                          per_rank if R == 1 else 0)
        return [total.copy() for _ in range(R)]

    def exscan_sum(self, values: Sequence[int]) -> list[int]:
        """Exclusive prefix sum of scalars (used for global offsets — the
        paper's 'global offset of 20 added on concatenation', §2.2.4)."""
        arr = np.asarray([int(v) for v in values], dtype=_INT)
        out = (np.cumsum(arr) - arr).tolist()
        self.stats.record(8 * (self.nranks - 1), 0)
        return [int(v) for v in out]
