"""Training runs on every process of a mesh, restarted on meshes of other
process counts: the harness of the elastic-restart example
(``repro_torch.examples.elastic_restart``), of ``chip_smoke.py``'s elastic
phase and of the multi-process tests.

A :class:`Phase` is one run of the ``TorchTrainer`` on a ("data", "model")
mesh of the process group that is already started (one process per device
of the mesh): it restores a committed step (or carries on from the state
the previous phase ended in), trains, and checks what it restored against
a kept state bit for bit.  ``run_phases`` runs a list of them in turn, so
one set of spawned processes (``launch.spawn.run_processes``) can run
several.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device, use_deterministic_algorithms
from repro_torch.distrib.group import PeerFailed
from repro_torch.distrib.rules import local_box, rules_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.loop import TorchTrainer, TrainerConfig
from repro_torch.train.optim import make_optimizer
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import init_train_state, make_train_step


@dataclasses.dataclass(frozen=True)
class Phase:
    """One run of the trainer on every process of a mesh.

    The run restores committed step ``from_step`` (default: the latest, or a
    fresh init), or with ``carry_on`` takes the state the previous phase
    of ``run_phases`` ended in, and trains to ``steps``, saving every
    ``ckpt_every``.  ``store_factory`` (root, mode) -> store replaces the
    trainer's ``DatasetStore`` (a fault-injecting one, say: it must pickle,
    to reach spawned processes); with ``expect_crash`` the run must raise
    on every process, as when rank 0's writer dies.  ``keep`` names a
    file where rank 0 writes the whole state the run ends in; ``verify``
    one whose arrays every process's restored shards must equal, bit for
    bit."""
    mesh: tuple[int, int]
    steps: int
    ckpt_dir: str
    expect_start: int
    from_step: int | None = None
    carry_on: bool = False
    store_factory: Callable[[str, str], object] | None = None
    expect_crash: bool = False
    keep: str | None = None
    verify: str | None = None
    arch: str = "qwen3_1_7b"
    smoke: bool = True
    num_layers: int | None = None       # cut the depth of the full config
    attention_impl: str | None = None
    seq: int = 32
    batch: int = 8
    ckpt_every: int = 10
    base_lr: float = 3e-3
    warmup: int = 10
    total: int = 100
    device: str = "cpu"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def run_phase(ph: Phase, carry=None) -> dict:
    """Run ``ph`` on this process (every process of the mesh calls it, in a
    process group that is already started).  Returns what this process saw
    (step seconds are synchronised on the card)."""
    return _run_phase(ph, carry)[0]


def _run_phase(ph: Phase, carry):
    device = resolve_device(ph.device)
    if device.type == "cuda":
        use_deterministic_algorithms()
    cfg = get_smoke_config(ph.arch) if ph.smoke else get_config(ph.arch)
    if ph.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=ph.num_layers)
    if ph.attention_impl is not None:
        cfg = dataclasses.replace(cfg, attention_impl=ph.attention_impl)
    api = build_model(cfg)
    mesh = make_debug_mesh(*ph.mesh, device_type=device.type)
    rules = rules_for(cfg.arch)
    opt = make_optimizer(cfg.optimizer)
    sched = functools.partial(warmup_cosine, base_lr=ph.base_lr,
                              warmup=ph.warmup, total=ph.total)
    step = make_train_step(api, opt, sched,
                           ShapeConfig("ex", ph.seq, ph.batch, "train"),
                           mesh=mesh, rules=rules)
    step_seconds = []

    def timed(state, batch, fn=step.fn):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t)
        return out

    step = dataclasses.replace(step, fn=timed)
    data = SyntheticLM(cfg.vocab, ph.seq, ph.batch, seed=0)
    tcfg = TrainerConfig(
        ckpt_dir=ph.ckpt_dir, ckpt_every=ph.ckpt_every, log_every=1,
        store_factory=ph.store_factory)
    tr = TorchTrainer(step, data, tcfg, device=device,
                      init_state_fn=lambda: init_train_state(
                          api, opt,
                          torch.Generator(device=device).manual_seed(0)))
    rank = dist.get_rank()
    out: dict = {"mesh": ph.mesh, "world": dist.get_world_size()}
    t0 = time.perf_counter()
    if ph.carry_on:
        state, start = carry
    elif ph.from_step is None:
        state, start = tr.restore_latest()
    else:
        state, start = tr.restore_from(ph.from_step)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["restore_seconds"] = time.perf_counter() - t0
    if start != ph.expect_start:
        raise AssertionError(f"restored step {start}, not {ph.expect_start}")
    out["start"] = start
    out["example_placements"] = {
        k: str(tuple(state[k].placements))
        for k in ("params/wq", "params/embed") if k in state}
    if ph.verify is not None:
        kept = torch.load(ph.verify)
        differ = [k for k, t in state.items()
                  if not torch.equal(
                      _bits(t.to_local()),
                      _bits(kept[k][local_box(t.shape, mesh,
                                              t.placements).slices()]))]
        if sorted(kept) != sorted(state) or differ:
            raise AssertionError(f"rank {rank}: restored arrays differ from "
                                 f"{ph.verify}: {differ}")
        out["bit_equal_arrays"] = len(state)
    t0 = time.perf_counter()
    try:
        res = tr.run(ph.steps, start_state=state, start_step=start)
    except (RuntimeError, PeerFailed) as e:
        if not ph.expect_crash:
            raise
        out["crash"] = f"{type(e).__name__}: {e.__cause__ or e}"
        out["run_seconds"] = time.perf_counter() - t0
        out["history"] = tr.history
        return out, None
    if ph.expect_crash:
        raise AssertionError("the expected crash never came")
    out["run_seconds"] = time.perf_counter() - t0
    out["step_seconds"] = step_seconds
    out["history"] = tr.history
    out["losses_finite"] = bool(np.all(np.isfinite(
        [h["loss"] for h in tr.history])))
    out["save_log"] = tr.save_log
    if ph.keep is not None:
        full = {k: t.full_tensor().cpu() for k, t in res["state"].items()}
        if rank == 0:
            torch.save(full, ph.keep)
        del full
    return out, (res["state"], ph.steps)


def run_phases(phases: list[Phase]) -> list[dict]:
    """``run_phase`` for each phase in turn, on this process; the first
    result also carries the wall-clock time this process entered."""
    entered, outs, carry = time.time(), [], None
    for ph in phases:
        out, carry = _run_phase(ph, carry)
        outs.append(out)
    outs[0]["entered_at"] = entered
    return outs
