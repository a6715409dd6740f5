"""Asynchronous checkpointing: serialize-then-write with bounded staging.

A copy of the JAX package's ``core/async_io.py``, its FEM facade included;
only the static-analysis markers are gone.

The training loop / simulation must not stall on the filesystem (the paper's
save times — Table 6.3 — are seconds to minutes at scale).  The pipeline is
the Kohl et al. (arXiv 1708.08286) serialize-then-write template:

  1. **serialize** (synchronous, cheap): the mutable state — tensor shard
     blocks, mesh coordinates, function DoF vectors — is copied in ONE flat
     rank-flat pass into a slab of the :class:`StagingArena` (on TPU this is
     the device-to-host transfer);
  2. **write** (background): a single daemon writer thread drains submitted
     snapshots through the ordinary ``TensorCheckpoint`` /
     ``FEMCheckpoint`` save paths and finally writes the commit marker.

Staging-budget semantics
------------------------
The arena holds **at most two snapshots alive** (double buffering: one being
written, one being staged) inside a configurable byte budget
(``staging_budget_bytes``; ``None`` = bounded only by the two-snapshot rule).
``submit``/``save_mesh``/``save_function`` apply **back-pressure**: they block
until the in-flight write releases its slab whenever a third snapshot is
submitted or the budget would be exceeded, trading overlap for bounded host
memory.  A single snapshot larger than the whole budget can never fit and
raises ``ValueError`` up front.  Slabs are preallocated on first use and
reused (grown, never shrunk) by every later snapshot, so the steady state
performs zero allocations beyond the one flat copy.

Recovery contract (the crash-consistency invariant)
---------------------------------------------------
A job may die at ANY write operation.  The invariant — tested exhaustively
by the crash-point grid in ``tests/test_async_and_failures.py`` — is that
the **last committed step is always loadable, bit-exact, on any rank
count**, and a torn (uncommitted) step is never visible:

* every store mutation for a step is ordered BEFORE that step's commit
  marker, and the marker itself is a single atomic ``os.replace`` of the
  store's JSON attrs;
* tensor state: ``TensorCheckpoint.save_state`` writes
  ``meta["steps"][step]`` last — ``steps()``/``load_state`` only ever see
  committed steps;
* FEM meshes and functions: after the underlying save returns, the writer
  appends one entry to the ``async/commit_log`` attr (:data:`COMMIT_LOG_KEY`)
  as the **last** operation of the job.  ``FEMCheckpoint.load_mesh`` /
  ``load_function`` / ``steps`` consult the log when it exists, so a crash
  anywhere between the first byte of a save and its commit entry leaves the
  previous committed state as the restart point.  (Stores written purely by
  the synchronous paths carry no log and keep their historical semantics —
  the golden-format fixtures are unchanged.)  Once a store is managed
  through :class:`AsyncCheckpointer`, route every save through it: a
  synchronous ``save_function`` on the side would write datasets without a
  commit entry and be treated as torn;
* **series steps**: when a step's saves are bracketed by ``begin_step`` /
  ``commit_step``, every queued mutation stages into the store's open
  series step — data extents land on disk as written (content-hash
  dedup-aliased against earlier steps), but the step's manifest entry, its
  commit-log entries and ALL attr writes are deferred into
  ``DatasetStore.commit_step``'s single atomic ``os.replace``.  The
  manifest entry IS the commit marker: the marker-written-LAST contract
  collapses to one flush.  A crash — or a failed writer job, which makes
  the writer skip every queued job *including the commit* — anywhere
  before that flush leaves orphan extents but no manifest entry, no attrs
  and no log entries, so ``steps()`` reports the exact committed prefix
  and loading the torn step raises ``ValueError``.

Mesh topology (cones, global numbers, ownership) is assumed immutable while
a save is in flight — only coordinates, labels and function values are
snapshotted.  Mutating topology mid-save is undefined behaviour, exactly as
it is for the synchronous path.

Writer-thread failures are surfaced on the NEXT ``submit``/``save_mesh``/
``save_function`` as well as on ``wait`` (a long-running loop that never
calls ``wait`` still finds out).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Callable

import numpy as np

from repro_torch.core.comm import Comm
from repro_torch.core.store import COMMIT_LOG_KEY, DEFAULT_SERIES, DatasetStore
from repro_torch.core.tensor_ckpt import ArrayShard, PerRankState, TensorCheckpoint

# COMMIT_LOG_KEY — the attr holding the append-only list of commit entries
# written by the async writer — is owned by this module but defined in
# ``core.store`` (re-exported here) so ``StepView`` can mask it without a
# circular import.
__all__ = ["COMMIT_LOG_KEY", "AsyncCheckpointer", "StagingArena",
           "ArenaStats", "pack_flat"]


# ============================================================= staging arena
@dataclasses.dataclass
class ArenaStats:
    acquires: int = 0
    backpressure_hits: int = 0        # acquires that had to block
    blocked_seconds: float = 0.0
    peak_live_bytes: int = 0          # max sum of concurrently-alive snapshots


class StagingArena:
    """At most ``max_slots`` reusable flat host slabs under one byte budget.

    ``acquire`` blocks (back-pressure) while no slot is free or the budget
    is exhausted; ``release`` (writer side) wakes the waiter.  Slabs are
    uint8 and grown to the largest snapshot seen, then reused.
    """

    def __init__(self, budget_bytes: int | None = None, max_slots: int = 2):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(
                f"StagingArena: budget must be positive or None, got "
                f"{budget_bytes}")
        if max_slots < 1:
            raise ValueError(f"StagingArena: need >= 1 slot, got {max_slots}")
        self.budget_bytes = budget_bytes
        self.stats = ArenaStats()
        self._cond = threading.Condition()
        self._slabs: list[np.ndarray | None] = [None] * max_slots
        self._free: list[int] = list(range(max_slots))
        self._used: list[int] = [0] * max_slots
        self._live_bytes = 0

    def acquire(self, nbytes: int) -> int:
        """Reserve a slot for an ``nbytes`` snapshot; blocks under pressure."""
        nbytes = int(nbytes)
        if self.budget_bytes is not None and nbytes > self.budget_bytes:
            raise ValueError(
                f"StagingArena: a single {nbytes}-byte snapshot exceeds the "
                f"staging budget of {self.budget_bytes} bytes — raise the "
                f"budget or shrink the checkpointed state")
        with self._cond:
            self.stats.acquires += 1
            t0 = time.perf_counter()
            waited = False
            while not (self._free
                       and (self.budget_bytes is None
                            or self._live_bytes + nbytes
                            <= self.budget_bytes)):
                waited = True
                self._cond.wait()
            if waited:
                self.stats.backpressure_hits += 1
                self.stats.blocked_seconds += time.perf_counter() - t0
            slot = self._free.pop()
            slab = self._slabs[slot]
            if slab is None or slab.size < nbytes:
                self._slabs[slot] = np.empty(nbytes, dtype=np.uint8)
            self._used[slot] = nbytes
            self._live_bytes += nbytes
            self.stats.peak_live_bytes = max(self.stats.peak_live_bytes,
                                             self._live_bytes)
            return slot

    def buffer(self, slot: int) -> np.ndarray:
        """The slot's flat uint8 buffer, sized to the acquired snapshot."""
        with self._cond:       # _used is reset by the writer-side release
            slab = self._slabs[slot]
            if slab is None:
                raise ValueError(
                    f"StagingArena: slot {slot} was never acquired")
            return slab[:self._used[slot]]

    def release(self, slot: int) -> None:
        with self._cond:
            self._live_bytes -= self._used[slot]
            self._used[slot] = 0
            self._free.append(slot)
            self._cond.notify_all()


# ======================================================== flat snapshotting
def pack_flat(blocks: list[np.ndarray], buf: np.ndarray | None = None
              ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Copy ``blocks`` into ONE flat uint8 buffer in a single pass.

    Returns ``(buf, views)`` where ``views[i]`` is ``blocks[i]`` re-exposed
    (same dtype/shape) as a zero-copy view of ``buf``.  The copy is one
    ``np.concatenate(..., out=...)`` over the blocks' uint8 views — no
    per-rank/per-array Python copy loop, any mix of dtypes."""
    flats = [np.ascontiguousarray(b).view(np.uint8).reshape(-1)
             for b in blocks]
    sizes = np.fromiter((f.size for f in flats), dtype=np.int64,
                        count=len(flats))
    bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    nbytes = int(bounds[-1])
    if buf is None:
        buf = np.empty(nbytes, dtype=np.uint8)
    elif buf.size < nbytes:
        raise ValueError(
            f"pack_flat: staging buffer holds {buf.size} bytes but the "
            f"snapshot needs {nbytes}")
    if nbytes:
        np.concatenate(flats, out=buf[:nbytes])
    views = [buf[a:b].view(np.asarray(blk).dtype).reshape(np.shape(blk))
             for blk, a, b in zip(blocks, bounds[:-1], bounds[1:])]
    return buf, views


def _snapshot(per_rank: PerRankState, buf: np.ndarray | None = None
              ) -> PerRankState:
    """Rank-flat state snapshot: every shard block of every rank copied in
    ONE flat pass into ``buf`` (or a fresh buffer), handed back as the same
    ``PerRankState`` structure of views."""
    shard_seq = [sh for st in per_rank for sh in st.values()]
    blocks = [sh.data[int(o)] for sh in shard_seq for o in sh.ordinals]
    _, views = pack_flat(blocks, buf)
    counts = np.fromiter((len(sh.ordinals) for sh in shard_seq),
                         dtype=np.int64, count=len(shard_seq))
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    grouped = iter([views[a:b] for a, b in zip(bounds[:-1], bounds[1:])])
    return [{name: ArrayShard(sh.ordinals.copy(),
                              dict(zip((int(o) for o in sh.ordinals),
                                       next(grouped))))
             for name, sh in st.items()}
            for st in per_rank]


def _state_nbytes(per_rank: PerRankState) -> int:
    return sum(int(blk.nbytes)
               for st in per_rank for sh in st.values()
               for blk in sh.data.values())


# ================================================================ the writer
@dataclasses.dataclass
class _Job:
    run: Callable[[], None]
    slot: int | None
    label: str
    commit: dict | None = None         # commit-log entry, written LAST
    step: int | None = None            # tensor step (completed_steps)


class AsyncCheckpointer:
    """Single async front door for tensor AND FEM checkpointing.

    Accepts a :class:`TensorCheckpoint`, a ``FEMCheckpoint`` or a bare
    :class:`DatasetStore` (both facades are built on demand over the same
    store).  ``submit`` saves tensor state; ``save_mesh``/``save_function``
    mirror the ``FEMCheckpoint`` API.  All three serialize synchronously
    into the bounded :class:`StagingArena` and return; one daemon writer
    drains the jobs in submission order and writes each job's commit marker
    last (see the module docstring for the recovery contract).
    """

    def __init__(self, ckpt, comm: Comm, *,
                 staging_budget_bytes: int | None = None):
        if isinstance(ckpt, TensorCheckpoint):
            self.store = ckpt.store
            self.ckpt = ckpt
            self._fem = None
        elif isinstance(ckpt, DatasetStore):
            self.store = ckpt
            self.ckpt = TensorCheckpoint(ckpt)
            self._fem = None
        elif hasattr(ckpt, "store"):       # FEMCheckpoint (duck-typed: no
            self.store = ckpt.store        # eager core -> fem import)
            self.ckpt = TensorCheckpoint(ckpt.store)
            self._fem = ckpt
        else:
            raise TypeError(
                f"AsyncCheckpointer needs a TensorCheckpoint, FEMCheckpoint "
                f"or DatasetStore, got {type(ckpt).__name__}")
        self.comm = comm
        # mark the store async-managed BEFORE any data write: a crash before
        # the first commit must leave an (empty) log, not a store that
        # masquerades as a complete legacy sync store
        if self.store.mode in ("w", "a") \
                and not self.store.has_attrs(COMMIT_LOG_KEY):
            self.store.set_attrs(COMMIT_LOG_KEY, [])
        self.arena = StagingArena(staging_budget_bytes)
        self.completed_steps: list[int] = []
        self.job_log: list[dict] = []    # {"label", "t0", "t1", "seconds"}
        self._series_label = "?"         # last begin_step, for job labels
        # test hook: raised inside the writer thread to simulate a crash
        self.fail_on_step: int | None = None
        self._queue: queue.Queue[_Job] = queue.Queue()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ fem facade
    @property
    def fem(self):
        if self._fem is None:
            from repro_torch.fem.checkpoint import FEMCheckpoint
            self._fem = FEMCheckpoint(self.store)
        return self._fem

    # ------------------------------------------------------------------- api
    def submit(self, per_rank: PerRankState, step: int) -> None:
        """Snapshot tensor state synchronously, write asynchronously."""
        self._raise_pending()              # writer errors surface here too
        slot = self.arena.acquire(_state_nbytes(per_rank))
        try:
            snap = _snapshot(per_rank, self.arena.buffer(slot))
        except BaseException:
            self.arena.release(slot)
            raise

        def run(snap=snap, step=int(step)):
            if self.fail_on_step == step:
                raise IOError(f"injected failure while writing step {step}")
            self.ckpt.save_state(snap, self.comm, step)

        self._enqueue(_Job(run, slot, f"state/s{step}",
                           commit={"kind": "state", "step": int(step)},
                           step=int(step)))

    def save_mesh(self, name: str, plexes: list, comm: Comm | None = None,
                  labels: dict[str, list[np.ndarray]] | None = None) -> None:
        """Async ``FEMCheckpoint.save_mesh``: coordinates and labels are
        snapshotted (topology is immutable by contract); the commit-log
        entry for the mesh — which also covers its coordinate function —
        is the job's last write."""
        self._raise_pending()
        label_names = sorted(labels) if labels else []
        blocks = ([lp.vcoords for lp in plexes if lp.vcoords is not None]
                  + [np.asarray(v) for ln in label_names
                     for v in labels[ln]])
        slot = self.arena.acquire(sum(int(b.nbytes) for b in blocks))
        try:
            _, views = pack_flat(blocks, self.arena.buffer(slot))
            seq = iter(views)
            snap_plexes = [dataclasses.replace(
                lp, vcoords=(next(seq) if lp.vcoords is not None else None))
                for lp in plexes]
            snap_labels = ({ln: [next(seq) for _ in labels[ln]]
                            for ln in label_names} if labels else None)
        except BaseException:
            self.arena.release(slot)
            raise
        use_comm = comm if comm is not None else self.comm

        def run():
            self.fem.save_mesh(name, snap_plexes, use_comm,
                               labels=snap_labels)

        self._enqueue(_Job(run, slot, f"mesh/{name}",
                           commit={"kind": "mesh", "mesh": name}))

    def save_function(self, mesh: str, fname: str, funcs: list,
                      comm: Comm | None = None,
                      time_index: int | None = None) -> None:
        """Async ``FEMCheckpoint.save_function``: the DoF vectors ("dats")
        are snapshotted; the commit-log entry naming ``time_index`` is the
        job's last write."""
        self._raise_pending()
        from repro_torch.fem.function import Function
        blocks = [f.values for f in funcs]
        slot = self.arena.acquire(sum(int(b.nbytes) for b in blocks))
        try:
            _, views = pack_flat(blocks, self.arena.buffer(slot))
            snap_funcs = [Function(f.space, v)
                          for f, v in zip(funcs, views)]
        except BaseException:
            self.arena.release(slot)
            raise
        use_comm = comm if comm is not None else self.comm

        def run():
            self.fem.save_function(mesh, fname, snap_funcs, use_comm,
                                   time_index=time_index)

        self._enqueue(_Job(
            run, slot, f"func/{fname}"
            + ("" if time_index is None else f"/t{time_index}"),
            commit={"kind": "func", "mesh": mesh, "fname": fname,
                    "step": time_index}))

    def begin_step(self, step: int, series: str = DEFAULT_SERIES) -> None:
        """Open series step ``step`` (ordered on the writer thread): every
        save queued until ``commit_step`` stages into the step."""
        self._raise_pending()
        self._series_label = f"s{int(step)}"

        def run(step=int(step)):
            # the matching commit_step is its own queued writer job, so the
            # open step intentionally outlives this job's function scope
            self.store.begin_step(step, series)  # ckptlint: disable=CKPT007

        self._enqueue(_Job(run, None, f"begin/{self._series_label}"))

    def commit_step(self) -> None:
        """Commit the open series step — the job's ONLY write is the single
        atomic flush that makes the step visible.  If any queued save of the
        step failed, the writer skips this job too and the step stays
        invisible (torn), exactly like a crash."""
        self._raise_pending()
        self._enqueue(_Job(self.store.commit_step, None,
                           f"commit/{self._series_label}"))

    def wait(self) -> None:
        """Drain every submitted job; re-raise the first writer failure."""
        self._queue.join()
        self._raise_pending()

    @property
    def in_flight(self) -> bool:
        return self._queue.unfinished_tasks > 0

    # ------------------------------------------------------------- internals
    def _raise_pending(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def _enqueue(self, job: _Job) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True,
                name="async-ckpt-writer")
            self._thread.start()
        self._queue.put(job)

    def _writer_loop(self) -> None:
        while True:
            job = self._queue.get()
            try:
                # after a failure the simulated process is dead: skip any
                # queued jobs so no later step can commit past the crash
                with self._lock:
                    failed = self._error is not None
                if not failed:
                    t0 = time.perf_counter()
                    job.run()
                    if job.commit is not None:
                        _append_commit(self.store, job.commit)
                    t1 = time.perf_counter()
                    with self._lock:
                        self.job_log.append(
                            {"label": job.label, "t0": t0,
                             "t1": t1, "seconds": t1 - t0})
                        if job.step is not None:
                            self.completed_steps.append(job.step)
            except BaseException as e:   # noqa: BLE001 — surfaced on submit/wait
                with self._lock:
                    if self._error is None:
                        self._error = e
                traceback.clear_frames(e.__traceback__)
            finally:
                if job.slot is not None:
                    self.arena.release(job.slot)
                self._queue.task_done()


def _append_commit(store: DatasetStore, entry: dict) -> None:
    """Append one entry to the commit log; the single ``set_attrs`` is the
    atomic commit point (``store.json`` replaced via ``os.replace``)."""
    # copy before appending: inside a series step the append must stage (see
    # DatasetStore.set_attrs), never mutate the committed list in place
    log = (list(store.get_attrs(COMMIT_LOG_KEY))
           if store.has_attrs(COMMIT_LOG_KEY) else [])
    log.append(entry)
    store.set_attrs(COMMIT_LOG_KEY, log)
