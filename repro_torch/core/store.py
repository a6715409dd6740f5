"""On-disk dataset store — the HDF5-on-Lustre analogue.

The paper saves to a single HDF5 file on a striped Lustre filesystem; every
rank writes/reads row ranges of shared datasets concurrently.  ``h5py`` is not
available here, so :class:`DatasetStore` provides the same contract with plain
files:

  * a *dataset* is a named 2-D-or-1-D typed array backed by one ``.bin`` file
    (row-major), created with a known row count and dtype;
  * ranks write **contiguous row ranges** (``write_rows``) — the fast path the
    paper optimises for (§2.2.3: each process saves its part of the global DoF
    vector concurrently) — or **scattered rows** (``write_rows_at``), the slow
    path (topology/labels in global-number order; cf. Table 6.3 where
    Topology/Labels saving is far slower than Vec);
  * ranks read contiguous ranges (``read_rows``) or scattered rows
    (``read_rows_at`` — the loader's closure fetches);
  * JSON attributes (``set_attrs``/``get_attrs``) play the role of HDF5
    attributes/groups;
  * all traffic is accounted in :attr:`IOStats` so benchmarks can report
    bandwidth per phase exactly like Tables 6.1–6.5;
  * ``buffer_rows`` emulates the Lustre *stripe size* tuning knob: writes are
    staged through a bounce buffer of that many rows (benchmarks sweep it).

Writes of disjoint row ranges from different (simulated) ranks are safe and
order-independent, which is the property the parallel-FS path relies on.

Batched I/O plans
-----------------
``write_plan``/``read_plan`` take the per-rank ``(start, rows)`` segments of
ONE dataset and execute them as a single open plus one coalesced pass:
segments are sorted by start and maximal contiguous runs become one
seek+write (or seek+read) each, so :attr:`IOStats.write_calls` /
:attr:`IOStats.read_calls` count the *aggregated* operations — the
collective-buffering model of MPI-IO/HDF5, where many small per-process
accesses are widened into few contiguous ones before touching the
filesystem.  The convention throughout the checkpoint layers is **one plan
per dataset per phase**: callers collect every rank's segment for a dataset
and issue one plan call instead of a ``for r in range(R)`` loop, which keeps
the call count per dataset independent of the rank count.  Byte totals are
unchanged (plans write/read exactly the requested rows), so dataset bytes on
disk are identical to the per-rank-loop path.

Timestep series
---------------
A store can also hold an **append-only series** of checkpoint steps (the
sapphire ``DumbCheckpoint``/``set_timestep`` idiom).  The series lives in one
JSON attr (:data:`SERIES_KEY`) holding, per series, a *manifest*:

  * ``steps``  — ``{step: {logical_name: physical_dataset}}``: O(1) lookup of
    any committed step's datasets;
  * ``hashes`` — ``{content_hash: physical_dataset}``: the dedup index.  A
    dataset whose bytes are unchanged between steps is stored once and merely
    *aliased* in later steps' manifests (zero bytes written).

``begin_step`` opens a step; every ``staged_write``/``stage_dataset`` then
lands under a step-scoped physical name (or aliases an existing extent on a
hash hit) and every ``set_attrs`` is *deferred*; ``commit_step`` merges the
step's manifest entry, its staged attrs, and its hash-index additions into
``store.json`` with ONE atomic replace — the manifest entry IS the commit
marker.  A crash before ``commit_step`` leaves orphan extents on disk but no
manifest entry, so ``steps()`` never shows a torn step and ``step_datasets``
raises ``ValueError`` for it.  A store with no series attr is the degenerate
one-step layout: nothing about the legacy single-snapshot byte format
changes.  :class:`StepView` is the read side: a proxy that resolves logical
names through one committed step's manifest so the load engines work
unmodified on any step of a stream.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any

import numpy as np


#: attr key of the per-series step manifests (absent on legacy stores)
SERIES_KEY = "series/manifest"
#: attr key of the async writer's commit log (owned by ``core/async_io``;
#: defined here so :class:`StepView` can mask it without a circular import)
COMMIT_LOG_KEY = "async/commit_log"
#: series name used when callers don't pick one
DEFAULT_SERIES = "series"


#: dtypes numpy lacks, carried on the host as raw words of the same width.
#: ``store.json`` and the content hash still name the real dtype, so a store
#: written here and one written by the JAX package (which holds bfloat16
#: through ``ml_dtypes``) are byte-for-byte interchangeable.
HOST_WORDS = {"bfloat16": np.dtype(np.uint16)}


def dtype_name(dtype) -> str:
    """Stored name of ``dtype``: ``"bfloat16"``, ``"float32"``, ``"int64"``..."""
    name = str(dtype)
    return name if name in HOST_WORDS else str(np.dtype(dtype))


def content_hash(arrays, starts=None, dtype=None) -> str:
    """Content fingerprint of one dataset's segments for step-level dedup.

    Identical (placement, dtype, shape, bytes) ⇒ identical hash, so a dataset
    unchanged between steps aliases the stored extent instead of being
    rewritten.  ``starts`` (when given) orders the segments canonically and
    is folded into the digest — same bytes at different row offsets are a
    different dataset.  ``dtype`` (when given) is the dataset's stored dtype
    name, hashed in place of the host arrays' own: bfloat16 segments travel
    as uint16 words but must digest as ``bfloat16``, as the reference's do.
    """
    pairs = list(zip(starts, arrays)) if starts is not None \
        else list(enumerate(arrays))
    pairs.sort(key=lambda p: int(p[0]))
    h = hashlib.blake2b(digest_size=16)
    for start, a in pairs:
        a = np.ascontiguousarray(a)
        name = a.dtype if dtype is None else dtype
        h.update(f"{int(start)}:{name}:{a.shape};".encode())
        if a.size:
            h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def np_dtype(name) -> np.dtype:
    """Host dtype of a stored dtype name: numpy's own, or the raw words of
    one numpy lacks (``bfloat16`` -> ``uint16``; see :data:`HOST_WORDS`)."""
    words = HOST_WORDS.get(str(name))
    return words if words is not None else np.dtype(name)


@dataclasses.dataclass
class IOStats:
    bytes_written: int = 0
    bytes_read: int = 0
    write_calls: int = 0
    read_calls: int = 0
    write_seconds: float = 0.0
    read_seconds: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DatasetStore:
    """A directory of named datasets + JSON attrs; one .bin file per dataset."""

    def __init__(self, root: str, mode: str = "r", buffer_rows: int | None = None):
        if mode not in ("r", "w", "a"):
            raise ValueError(f"store mode must be r/w/a, got {mode!r}")
        self.root = root
        self.mode = mode
        self.buffer_rows = buffer_rows
        self.stats = IOStats()
        self._read_fds: dict[str, Any] = {}   # dataset -> cached read handle
        self._pending: dict | None = None     # open (uncommitted) series step
        if mode == "w":
            os.makedirs(root, exist_ok=True)
            self._meta = {"datasets": {}, "attrs": {}}
            self._flush_meta()
        else:
            with open(self._meta_path()) as f:
                self._meta = json.load(f)

    # ------------------------------------------------------ read-handle cache
    def _reader(self, name: str):
        """Cached read handle (the loader's closure fetch issues thousands of
        scattered reads; re-opening per call dominated wall time)."""
        f = self._read_fds.get(name)
        if f is None:
            f = open(self._path(name), "rb")
            self._read_fds[name] = f
        return f

    def _invalidate_reader(self, name: str) -> None:
        """Drop the cached handle before any write so no stale buffered data
        survives a write-then-read on the same dataset."""
        f = self._read_fds.pop(name, None)
        if f is not None:
            f.close()

    def close(self) -> None:
        for f in self._read_fds.values():
            f.close()
        self._read_fds.clear()

    def __del__(self):  # best-effort; refcounting frees handles promptly
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------- metadata
    def _meta_path(self) -> str:
        return os.path.join(self.root, "store.json")

    def _flush_meta(self) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._meta, f, indent=1, sort_keys=True)
        os.replace(tmp, self._meta_path())  # atomic commit

    def set_attrs(self, key: str, value: Any) -> None:
        if self.mode not in ("w", "a"):
            raise ValueError(f"set_attrs({key!r}) on read-only store")
        if self._pending is not None:
            # inside a series step, attr writes are staged: they reach disk
            # only in commit_step's single atomic flush, so a torn step
            # leaves no attr traces (this is what folds the async commit log
            # into the manifest commit)
            self._pending["attrs"][key] = value
            return
        self._meta["attrs"][key] = value
        self._flush_meta()

    def get_attrs(self, key: str) -> Any:
        if self._pending is not None and key in self._pending["attrs"]:
            return self._pending["attrs"][key]
        return self._meta["attrs"][key]

    def has_attrs(self, key: str) -> bool:
        if self._pending is not None and key in self._pending["attrs"]:
            return True
        return key in self._meta["attrs"]

    def datasets(self) -> list[str]:
        return sorted(self._meta["datasets"])

    def has_dataset(self, name: str) -> bool:
        return name in self._meta["datasets"]

    # ------------------------------------------------------ timestep series
    def _manifest(self, series: str) -> dict:
        return self._meta["attrs"].get(SERIES_KEY, {}).get(
            series, {"steps": {}, "hashes": {}})

    def _require_pending(self) -> dict:
        if self._pending is None:
            raise ValueError("no series step is open (call begin_step first)")
        return self._pending

    @property
    def pending_step(self) -> tuple[str, int] | None:
        """The open (series, step) pair, or ``None`` outside a step."""
        if self._pending is None:
            return None
        return (self._pending["series"], self._pending["step"])

    def begin_step(self, step: int, series: str = DEFAULT_SERIES) -> None:
        """Open series step ``step``; writes nothing to disk by itself.

        Series are append-only: ``step`` must exceed every committed step of
        ``series``, and only one step may be open per store at a time.
        """
        if self.mode not in ("w", "a"):
            raise ValueError(f"begin_step({step}) on read-only store")
        if self._pending is not None:
            raise ValueError(
                f"begin_step({step}): step {self._pending['step']} of series "
                f"{self._pending['series']!r} is still open")
        committed = self.steps(series)
        step = int(step)
        if committed and step <= committed[-1]:
            raise ValueError(
                f"begin_step({step}): series {series!r} is append-only and "
                f"already committed step {committed[-1]}")
        self._pending = {"series": series, "step": step, "datasets": {},
                         "new_hashes": {}, "attrs": {}}

    def stage_dataset(self, name: str, h: str, rows: int,
                      row_shape: tuple[int, ...] = (),
                      dtype="float64") -> str | None:
        """Stage dataset ``name`` (content hash ``h``) in the open step.

        On a hash hit the existing extent is aliased in the step manifest and
        ``None`` is returned — zero bytes written, the dedup fast path.  On a
        miss a fresh step-scoped physical dataset is created and its name
        returned for the caller's ``write_plan``.
        """
        p = self._require_pending()
        phys = self._manifest(p["series"])["hashes"].get(h) \
            or p["new_hashes"].get(h)
        if phys is not None:
            p["datasets"][name] = phys
            return None
        phys = f"{p['series']}/s{p['step']}/{name}"
        self.create(phys, rows, row_shape, dtype)
        p["datasets"][name] = phys
        p["new_hashes"][h] = phys
        return phys

    def staged_write(self, name: str, rows: int, row_shape, dtype,
                     starts, arrays) -> None:
        """Create + one batched write of a whole dataset, series-aware.

        Outside a step this is exactly ``create`` + ``write_plan``.  Inside a
        step the dataset is staged through the manifest with content-hash
        dedup: an unchanged dataset aliases the stored extent and the write
        is skipped entirely.
        """
        if self._pending is None:
            self.create(name, rows, row_shape, dtype)
            self.write_plan(name, starts, arrays)
            return
        phys = self.stage_dataset(
            name, content_hash(arrays, starts, dtype_name(dtype)),
            rows, row_shape, dtype)
        if phys is not None:
            self.write_plan(phys, starts, arrays)

    def stage_carry(self, name: str) -> None:
        """Alias ``name`` in the open step to the physical extent it mapped
        to in the latest committed step that has it (caller asserts the
        content is unchanged — the engines use this when their own dedup,
        e.g. the tensor epoch fingerprint, already proved it)."""
        p = self._require_pending()
        man = self._manifest(p["series"])
        for s in sorted((int(k) for k in man["steps"]), reverse=True):
            phys = man["steps"][str(s)].get(name)
            if phys is not None:
                p["datasets"][name] = phys
                return
        raise ValueError(
            f"stage_carry({name!r}): no committed step of series "
            f"{p['series']!r} maps it")

    def commit_step(self) -> None:
        """Commit the open step with ONE atomic ``store.json`` replace.

        The manifest entry, the staged attrs, and the hash-index additions
        all land in that single flush — the manifest entry IS the commit
        marker (the marker-written-LAST contract of ``core/async_io``), so a
        crash anywhere before this call leaves the step invisible.
        """
        p = self._require_pending()
        series = self._meta["attrs"].setdefault(SERIES_KEY, {})
        man = series.setdefault(p["series"], {"steps": {}, "hashes": {}})
        man["steps"][str(p["step"])] = p["datasets"]
        man["hashes"].update(p["new_hashes"])
        self._meta["attrs"].update(p["attrs"])
        # re-point: staged attrs must not resurrect a stale SERIES_KEY
        self._meta["attrs"][SERIES_KEY] = series
        self._pending = None
        self._flush_meta()

    def abort_step(self) -> None:
        """Drop the open step.  Extents it created stay on disk as orphans
        (exactly like a crash) but no manifest entry ever appears."""
        self._require_pending()
        self._pending = None

    def steps(self, series: str = DEFAULT_SERIES) -> list[int]:
        """Committed steps of ``series``, ascending ([] for no such series)."""
        return sorted(int(s) for s in self._manifest(series)["steps"])

    def step_datasets(self, step: int,
                      series: str = DEFAULT_SERIES) -> dict[str, str]:
        """O(1) logical→physical dataset mapping of one committed step.

        Torn or unknown steps raise ``ValueError`` naming the committed
        prefix — the load-side half of the crash-consistency contract.
        """
        man = self._manifest(series)
        entry = man["steps"].get(str(int(step)))
        if entry is None:
            raise ValueError(
                f"step {step} of series {series!r} is not committed "
                f"(committed steps: {self.steps(series)})")
        return dict(entry)

    def has_step(self, step: int, series: str = DEFAULT_SERIES) -> bool:
        return str(int(step)) in self._manifest(series)["steps"]

    def step_view(self, step: int,
                  series: str = DEFAULT_SERIES) -> "StepView":
        """Read-side view of one committed step (see :class:`StepView`)."""
        return StepView(self, step, series)

    # ------------------------------------------------------------- datasets
    def _path(self, name: str) -> str:
        return os.path.join(self.root, name.replace("/", "__") + ".bin")

    def _info(self, name: str) -> dict:
        return self._meta["datasets"][name]

    def _row_nbytes(self, info: dict) -> int:
        return int(np_dtype(info["dtype"]).itemsize * int(np.prod(info["row_shape"], initial=1)))

    def create(self, name: str, rows: int, row_shape: tuple[int, ...] = (),
               dtype="float64") -> None:
        """Create a dataset of ``rows`` rows; each row has shape ``row_shape``.

        The file is pre-sized (sparse) so that concurrent disjoint row-range
        writes need no coordination — the parallel-filesystem contract.
        """
        if self.mode not in ("w", "a"):
            raise ValueError(f"create({name!r}) on read-only store")
        info = {"rows": int(rows), "row_shape": [int(s) for s in row_shape],
                "dtype": dtype_name(dtype)}
        self._meta["datasets"][name] = info
        self._invalidate_reader(name)
        # both factors are Python ints (arbitrary precision — no int64
        # wrap), only the *stored* offsets are numpy-typed
        nbytes = self._row_nbytes(info) * int(rows)
        with open(self._path(name), "wb") as f:
            if nbytes:
                f.truncate(nbytes)
        self._flush_meta()

    def rows(self, name: str) -> int:
        return int(self._info(name)["rows"])

    def dtype(self, name: str) -> np.dtype:
        return np_dtype(self._info(name)["dtype"])

    def row_shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._info(name)["row_shape"])

    # --------------------------------------------------------------- writes
    def write_rows(self, name: str, start: int, data: np.ndarray) -> None:
        """Contiguous row-range write (the fast path)."""
        info = self._info(name)
        rb = self._row_nbytes(info)
        data = np.ascontiguousarray(data, dtype=np_dtype(info["dtype"]))
        if data.shape[1:] != tuple(info["row_shape"]):
            raise ValueError(
                f"{name}: row shape {data.shape[1:]} != {info['row_shape']}")
        if not (0 <= start and start + data.shape[0] <= info["rows"]):
            raise ValueError(
                f"{name}: write range [{start}, {start + data.shape[0]}) "
                f"out of range for {info['rows']} rows")
        self._invalidate_reader(name)
        t0 = time.perf_counter()
        buf_rows = self.buffer_rows or data.shape[0] or 1
        with open(self._path(name), "r+b") as f:
            f.seek(start * rb)
            raw = data.tobytes()  # staging copy == bounce buffer
            step = buf_rows * rb
            for off in range(0, len(raw), step):
                f.write(raw[off:off + step])
                self.stats.write_calls += 1
        self.stats.write_seconds += time.perf_counter() - t0
        self.stats.bytes_written += data.nbytes

    def write_plan(self, name: str, starts, arrays) -> None:
        """Batched multi-segment write: every rank's contiguous segment of one
        dataset in a single open + one coalesced pass.

        ``starts[i]`` is the first row of segment ``i`` and ``arrays[i]`` its
        rows.  Segments must be pairwise disjoint (the parallel-FS contract);
        maximal contiguous runs of segments are merged so one seek+write
        covers them — ``write_calls`` counts the coalesced operations (split
        only by the ``buffer_rows`` bounce buffer), not the segment count.
        Bytes on disk are identical to issuing ``write_rows`` per segment.
        """
        info = self._info(name)
        rb = self._row_nbytes(info)
        dt = np_dtype(info["dtype"])
        rows = int(info["rows"])
        if len(starts) != len(arrays):
            raise ValueError(
                f"{name}: {len(starts)} starts for {len(arrays)} arrays")
        segs = []
        for start, data in zip(starts, arrays):
            data = np.ascontiguousarray(data, dtype=dt)
            if data.shape[0] == 0:
                continue
            if data.shape[1:] != tuple(info["row_shape"]):
                raise ValueError(f"{name}: row shape {data.shape[1:]} != "
                                 f"{info['row_shape']}")
            start = int(start)
            if not (0 <= start and start + data.shape[0] <= rows):
                raise ValueError(
                    f"{name}: write segment [{start}, "
                    f"{start + data.shape[0]}) out of range for {rows} rows")
            segs.append((start, data))
        if not segs:
            return
        segs.sort(key=lambda s: s[0])
        for (a, d), (b, _) in zip(segs, segs[1:]):
            if a + d.shape[0] > b:
                raise ValueError(
                    f"{name}: overlapping write segments at row {b}")
        self._invalidate_reader(name)
        total = sum(d.nbytes for _, d in segs)
        t0 = time.perf_counter()
        with open(self._path(name), "r+b") as f:
            i = 0
            while i < len(segs):
                j, end = i + 1, segs[i][0] + segs[i][1].shape[0]
                while j < len(segs) and segs[j][0] == end:
                    end += segs[j][1].shape[0]
                    j += 1
                # stream the run segment-by-segment (no run-sized staging
                # copy), carrying the bounce-buffer slab accounting across
                # segment boundaries: write_calls is ceil(run/buffer) exactly
                # as if the run were one contiguous buffer
                buf_rows = self.buffer_rows or (end - segs[i][0]) or 1
                step = buf_rows * rb
                f.seek(segs[i][0] * rb)
                slab_left = 0
                for _, d in segs[i:j]:
                    # uint8 view, not memoryview/tobytes: zero-copy for
                    # every host dtype
                    raw = d.view(np.uint8).reshape(-1)
                    off = 0
                    while off < len(raw):
                        if slab_left == 0:
                            slab_left = step
                            self.stats.write_calls += 1
                        n = min(slab_left, len(raw) - off)
                        f.write(raw[off:off + n])
                        off += n
                        slab_left -= n
                i = j
        self.stats.write_seconds += time.perf_counter() - t0
        self.stats.bytes_written += total

    def write_rows_at(self, name: str, row_idx: np.ndarray, data: np.ndarray) -> None:
        """Scattered row writes (slow path: one seek+write per contiguous run)."""
        info = self._info(name)
        rb = self._row_nbytes(info)
        data = np.ascontiguousarray(data, dtype=np_dtype(info["dtype"]))
        row_idx = np.asarray(row_idx, dtype=np.int64)
        if row_idx.ndim != 1 or data.shape[0] != row_idx.shape[0]:
            raise ValueError(
                f"{name}: scattered write needs 1-D row_idx matching data "
                f"rows, got idx shape {row_idx.shape} for "
                f"{data.shape[0]} rows")
        if row_idx.size == 0:
            return
        self._invalidate_reader(name)
        order = np.argsort(row_idx, kind="stable")
        row_idx, data = row_idx[order], data[order]
        t0 = time.perf_counter()
        # coalesce maximal contiguous runs (the loader-side optimisation of
        # §"straggler mitigation" applies to writes too)
        breaks = np.flatnonzero(np.diff(row_idx) != 1) + 1
        starts = np.concatenate([[0], breaks, [row_idx.size]])
        with open(self._path(name), "r+b") as f:
            for a, b in zip(starts[:-1], starts[1:]):
                f.seek(int(row_idx[a]) * rb)
                f.write(data[a:b].tobytes())
                self.stats.write_calls += 1
        self.stats.write_seconds += time.perf_counter() - t0
        self.stats.bytes_written += data.nbytes

    # ---------------------------------------------------------------- reads
    def read_rows(self, name: str, start: int, count: int) -> np.ndarray:
        info = self._info(name)
        rb = self._row_nbytes(info)
        if not (0 <= start and 0 <= count and start + count <= info["rows"]):
            raise ValueError(
                f"{name}: read range [{start}, {start + count}) out of "
                f"range for {info['rows']} rows")
        # readinto a preallocated buffer: one pass instead of the old
        # read -> frombuffer -> copy (two passes over 268 MiB reads)
        out = np.empty((count, *info["row_shape"]), dtype=np_dtype(info["dtype"]))
        t0 = time.perf_counter()
        f = self._reader(name)
        f.seek(start * rb)
        got = f.readinto(out.reshape(-1).view(np.uint8))
        self.stats.read_seconds += time.perf_counter() - t0
        self.stats.read_calls += 1
        self.stats.bytes_read += int(got)
        if got != count * rb:
            raise ValueError(
                f"{name}: short read at row {start}: got {got} of "
                f"{count * rb} bytes")
        return out

    def read_plan(self, name: str, starts, counts) -> list[np.ndarray]:
        """Batched multi-segment contiguous read: every rank's ``(start,
        count)`` segment of one dataset in a single (cached) open + one
        coalesced pass.  Adjacent/overlapping segments merge into maximal
        runs — one seek+read per run, so ``read_calls`` counts the aggregated
        operations.  Returns the per-segment arrays in input order."""
        info = self._info(name)
        rb = self._row_nbytes(info)
        dt = np_dtype(info["dtype"])
        rows = int(info["rows"])
        starts = [int(s) for s in starts]
        counts = [int(c) for c in counts]
        if len(starts) != len(counts):
            raise ValueError(
                f"{name}: {len(starts)} starts for {len(counts)} counts")
        for s, c in zip(starts, counts):
            if not (0 <= s and 0 <= c and s + c <= rows):
                raise ValueError(
                    f"{name}: read segment [{s}, {s + c}) out of range "
                    f"for {rows} rows")
        order = sorted((i for i in range(len(starts)) if counts[i]),
                       key=lambda i: starts[i])
        out: list[np.ndarray] = [
            np.empty((c, *info["row_shape"]), dtype=dt) for c in counts]
        t0 = time.perf_counter()
        f = self._reader(name)
        i = 0
        while i < len(order):
            j = i + 1
            end = starts[order[i]] + counts[order[i]]
            while j < len(order) and starts[order[j]] <= end:
                end = max(end, starts[order[j]] + counts[order[j]])
                j += 1
            run_start = starts[order[i]]
            f.seek(run_start * rb)
            raw = f.read((end - run_start) * rb)
            self.stats.read_calls += 1
            self.stats.bytes_read += len(raw)
            run = np.frombuffer(raw, dtype=dt).reshape(
                (end - run_start, *info["row_shape"]))
            for k in order[i:j]:
                a = starts[k] - run_start
                out[k][...] = run[a:a + counts[k]]
            i = j
        self.stats.read_seconds += time.perf_counter() - t0
        return out

    def read_rows_at(self, name: str, row_idx: np.ndarray) -> np.ndarray:
        """Scattered row reads, coalesced into maximal contiguous runs."""
        info = self._info(name)
        row_idx = np.asarray(row_idx, dtype=np.int64)
        out = np.empty((row_idx.size, *info["row_shape"]),
                       dtype=np_dtype(info["dtype"]))
        if row_idx.size == 0:
            return out
        if int(row_idx.min()) < 0 or int(row_idx.max()) >= info["rows"]:
            raise ValueError(
                f"{name}: scattered read row index out of range "
                f"[0, {info['rows']})")
        order = np.argsort(row_idx, kind="stable")
        sorted_idx = row_idx[order]
        breaks = np.flatnonzero(np.diff(sorted_idx) != 1) + 1
        starts = np.concatenate([[0], breaks, [sorted_idx.size]])
        rb = self._row_nbytes(info)
        t0 = time.perf_counter()
        f = self._reader(name)
        for a, b in zip(starts[:-1], starts[1:]):
            # row index arrives id-scale from the closure loaders; mix the
            # byte offset in uint64 so the product cannot wrap int64
            f.seek(int(np.uint64(sorted_idx[a]) * np.uint64(rb)))
            raw = f.read((b - a) * rb)
            self.stats.read_calls += 1
            self.stats.bytes_read += len(raw)
            out[order[a:b]] = np.frombuffer(
                raw, dtype=np_dtype(info["dtype"])
            ).reshape((b - a, *info["row_shape"]))
        self.stats.read_seconds += time.perf_counter() - t0
        return out


class StepView:
    """Read-only view of one committed series step.

    Resolves *logical* dataset names through the step's manifest entry to the
    physical extents (which may be shared with other steps via dedup) and
    delegates every read to the parent store — same read-handle cache, same
    :class:`IOStats` — so the FE and tensor load engines work on any step of
    a stream without modification.  Names outside the manifest fall through
    untranslated (mixed stores).  The async commit log is masked: a step view
    exists only for a committed step, whose integrity the manifest already
    guarantees, so the per-entry log gating of the legacy layout must not
    second-guess it.
    """

    mode = "r"

    def __init__(self, store: DatasetStore, step: int,
                 series: str = DEFAULT_SERIES):
        self._store = store
        self.series = series
        self.step = int(step)
        self._map = store.step_datasets(step, series)

    @property
    def stats(self) -> IOStats:
        return self._store.stats

    def _phys(self, name: str) -> str:
        return self._map.get(name, name)

    # --- metadata -------------------------------------------------------
    def datasets(self) -> list[str]:
        return sorted(self._map)

    def has_dataset(self, name: str) -> bool:
        return name in self._map or self._store.has_dataset(name)

    def get_attrs(self, key: str) -> Any:
        if key == COMMIT_LOG_KEY:
            raise KeyError(key)
        return self._store.get_attrs(key)

    def has_attrs(self, key: str) -> bool:
        if key == COMMIT_LOG_KEY:
            return False
        return self._store.has_attrs(key)

    def rows(self, name: str) -> int:
        return self._store.rows(self._phys(name))

    def dtype(self, name: str) -> np.dtype:
        return self._store.dtype(self._phys(name))

    def row_shape(self, name: str) -> tuple[int, ...]:
        return self._store.row_shape(self._phys(name))

    # --- reads ----------------------------------------------------------
    def read_rows(self, name: str, start: int, count: int) -> np.ndarray:
        return self._store.read_rows(self._phys(name), start, count)

    def read_plan(self, name: str, starts, counts) -> list[np.ndarray]:
        return self._store.read_plan(self._phys(name), starts, counts)

    def read_rows_at(self, name: str, row_idx: np.ndarray) -> np.ndarray:
        return self._store.read_rows_at(self._phys(name), row_idx)

    def close(self) -> None:
        pass  # read handles belong to the parent store
