"""Fault-tolerant training loop, the counterpart of the JAX package's
``train/loop.py``: the paper's technique as the recovery path.

Every ``ckpt_every`` steps the loop snapshots the train state to host
memory (``ckpt_pack`` gathers each array's chunks on the card, one
device-to-host copy) and writes it through the N-to-M ``TensorCheckpoint``
on a background thread (double-buffered; the commit marker lands last, so
a crash mid-write falls back to the previous committed step).  A restart
goes through ``restore_latest``, the paper's load path, onto this process's
device, or, for a sharded step, onto the placements of the CURRENT mesh,
whatever mesh and process count saved it.

Sharded over a mesh of ``torch.distributed`` processes, every process
takes its data rank's rows of each global batch and snapshots its own
shards at a save, and rank 0 alone opens the store: it gathers the
snapshots and owns the ``AsyncCheckpointer``; the other processes hand
their snapshot over and go on.  Every store call rank 0 makes for all
(``distrib.group.root_call``) broadcasts its outcome, so when rank 0's
writer dies every process raises at the same save, or at the final wait,
instead of waiting at a collective.

The data pipeline state (next step index) and its seed ride in the
checkpoint attrs, so a restart resumes the exact token stream.  The store
files are the ones the reference ``Trainer`` writes, so either trainer
restarts from the other's directory.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.async_io import AsyncCheckpointer
from repro_torch.core.comm import Comm
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import (
    gather_snapshot,
    is_sharded,
    layout_from_torch,
    load_torch,
)
from repro_torch.device import resolve_device
from repro_torch.distrib import group as pg
from repro_torch.distrib.rules import local_box
from repro_torch.train.data import SyntheticLM
from repro_torch.train.step import TrainStep, shard_state


class SimulatedPreemption(RuntimeError):
    """Raised mid-run to emulate a node failure / wall-time kill."""


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    async_ckpt: bool = True
    log_every: int = 10
    # store constructor (root, mode) -> DatasetStore; lets harnesses swap in
    # an instrumented store (a fault-injecting one, say)
    store_factory: Callable[[str, str], DatasetStore] | None = None


class TorchTrainer:
    """Runs a :class:`TrainStep` on ``device`` (the card unless the caller
    asks for the CPU).  ``save_log`` records, per save, the synchronous
    snapshot's seconds (device-to-host included, and for a sharded step the
    gather to rank 0); the async writer's own ``job_log`` (rank 0's) has
    the write seconds.  A sharded step (``step.mesh``) runs with one
    process per device of its mesh, every process making the same calls;
    ``init_state_fn`` then returns the whole state, alike on every process
    (made from one seed), and each keeps its shards of it."""

    def __init__(self, step: TrainStep, data: SyntheticLM,
                 cfg: TrainerConfig, init_state_fn: Callable[[], dict],
                 device="cuda"):
        self.step = step
        self.data = data
        self.cfg = cfg
        self.init_state_fn = init_state_fn
        self.device = resolve_device(device)
        self.mesh = step.mesh
        self.comm = Comm(pg.world())
        self.history: list[dict] = []
        self.save_log: list[dict] = []
        self._async: AsyncCheckpointer | None = None
        self._ck: TensorCheckpoint | None = None     # rank 0's

    # ------------------------------------------------------------ ckpt io
    def _open_ckpt(self, mode: str) -> TensorCheckpoint:
        make = self.cfg.store_factory or DatasetStore
        return TensorCheckpoint(make(self.cfg.ckpt_dir, mode))

    def _committed(self) -> list[int]:
        try:
            return self._open_ckpt("r").steps()
        except FileNotFoundError:
            return []

    def init_state(self) -> dict:
        """The cold-start state, on this process's shards if sharded."""
        state = self.init_state_fn()
        if self.mesh is not None and not is_sharded(state):
            state = shard_state(state, self.mesh, self.step.state_shardings)
        return state

    def restore_latest(self) -> tuple[dict, int]:
        """(state on this trainer's device, start_step).  Fresh init if no
        committed checkpoint exists — the cold-start path."""
        steps = pg.root_call(self._committed)
        if not steps:
            return self.init_state(), 0
        return self.restore_from(steps[-1])

    def restore_from(self, step: int) -> tuple[dict, int]:
        """Restart-from-step-k: load committed step ``step`` of the
        checkpoint stream onto this trainer's device.  A torn or unknown
        step raises ``ValueError`` naming the committed prefix.  The stream
        is append-only, so a run resumed from an earlier step can only save
        steps beyond the last committed one."""
        step = int(step)

        ck = None                       # rank 0's

        def open_committed():
            nonlocal ck
            ck = self._open_ckpt("a")
            if step not in ck.steps():
                raise ValueError(
                    f"restore_from({step}): step is not committed "
                    f"(committed steps: {ck.steps()})")

        pg.root_call(open_committed)
        state = load_torch(ck, self.step.abstract_state, step,
                           device=self.device, mesh=self.mesh,
                           shardings=self.step.state_shardings)
        return state, step

    def _save(self, state: dict, step_idx: int) -> None:
        """Synchronous host snapshot; the store write is double-buffered
        on a daemon thread when cfg.async_ckpt.  Each save is one series
        step bracketed by ``begin_step``/``commit_step``: the manifest
        entry is the commit marker, so a crash mid-write falls back to the
        previous committed step, and unchanged arrays dedup against the
        stream (stored once, aliased in the manifest).

        Rank 0 opens the store (and writes the layout on the first save),
        every process snapshots its owned shards (one process: the whole
        state), rank 0 gathers them and writes them, synchronously or
        through its async writer.  When rank 0 fails, every process raises
        here."""
        t0 = time.perf_counter()

        def open_layout():
            ck = self._open_ckpt("a" if self._ckpt_exists() else "w")
            if not ck.store.has_attrs("layout"):
                ck.save_layout(layout_from_torch(state),
                               extra={"pipeline": self.data.state(step_idx)})
            self._ck = ck
            return ck.layout()

        per_rank = gather_snapshot(pg.root_call(open_layout), state)
        t1 = time.perf_counter()

        def write():
            ck = self._ck
            if not self.cfg.async_ckpt:
                ck.store.begin_step(step_idx)
                ck.save_state(per_rank, self.comm, step_idx)
                ck.store.commit_step()
                return
            if (self._async is None
                    or self._async.ckpt.store.root != ck.store.root):
                self._async = AsyncCheckpointer(ck, self.comm)
            self._async.begin_step(step_idx)
            self._async.submit(per_rank, step_idx)
            self._async.commit_step()

        pg.root_call(write)
        self.save_log.append({"step": step_idx, "async": self.cfg.async_ckpt,
                              "snapshot_seconds": t1 - t0,
                              "seconds": time.perf_counter() - t0})

    def wait_for_writes(self) -> None:
        """Drain the async writer; for a sharded step every process calls
        this, and raises if rank 0's writer failed."""
        pg.root_call(
            lambda: self._async is not None and self._async.wait())

    def _ckpt_exists(self) -> bool:
        return os.path.exists(os.path.join(self.cfg.ckpt_dir, "store.json"))

    # -------------------------------------------------------------- batches
    def _device_batch(self, step_idx: int) -> dict:
        """The step's inputs on this trainer's device: the global batch, or
        for a sharded step this process's rows of it (its box of each
        input's batch placements; ``SyntheticLM.shard_rows`` cuts the same
        rows)."""
        batch = self.data.batch(step_idx)
        out = {}
        for k, spec in self.step.abstract_batch.items():
            box = (None if self.mesh is None else local_box(
                spec.shape, self.mesh, self.step.batch_shardings[k]))
            if k not in batch:
                # extra inputs (e.g. whisper enc_frames) default to zeros,
                # made in torch: NumPy has no bfloat16 without ml_dtypes
                out[k] = torch.zeros(spec.shape if box is None else box.shape,
                                     dtype=getattr(torch, spec.dtype),
                                     device=self.device)
                continue
            arr = batch[k]
            if box is not None:
                arr = np.ascontiguousarray(arr[box.slices()])
            out[k] = torch.from_numpy(arr).to(self.device)
        return out

    # ----------------------------------------------------------------- run
    def run(self, num_steps: int, *, fail_at: int | None = None,
            start_state=None, start_step: int | None = None) -> dict:
        if start_state is None:
            state, start = self.restore_latest()
        else:
            state, start = start_state, int(start_step or 0)
        t0 = time.time()
        saved_steps = []
        for i in range(start, num_steps):
            if fail_at is not None and i == fail_at:
                # SIGTERM grace period: flush the in-flight async write
                # (the commit marker either lands whole or not at all)
                self.wait_for_writes()
                raise SimulatedPreemption(f"preempted at step {i}")
            batch = self._device_batch(i)
            state, metrics = self.step(state, batch)
            if self.cfg.log_every and (i + 1) % self.cfg.log_every == 0:
                self.history.append(
                    {"step": i + 1,
                     "loss": float(metrics["loss"]),
                     "lr": float(metrics["lr"])})
            if self.cfg.ckpt_every and (i + 1) % self.cfg.ckpt_every == 0:
                self._save(state, i + 1)
                saved_steps.append(i + 1)
        self.wait_for_writes()
        return {"state": state, "steps_run": num_steps - start,
                "saved_steps": saved_steps,
                "seconds": time.time() - t0,
                "history": self.history}
