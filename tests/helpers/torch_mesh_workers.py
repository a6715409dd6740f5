"""What the port's multi-process tests run on every process of a mesh
(``repro_torch.launch.spawn.run_processes``; module-level functions, so the
spawned processes import them by name).  Imports torch and the port only.

The checkpoint cases use one seeded state with every dtype the bridge
carries (f32, bf16, int32 and the 0-d ``step``) on specs that exercise each
kind of placement: a dim over one axis, a dim over both axes, a replicated
array (a ghost on every process but one) and a dim that does not divide
and degrades to replication.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist
from helpers.torch_faultstore import FaultStore
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.store import DatasetStore
from repro_torch.core.tensor_ckpt import TensorCheckpoint
from repro_torch.core.torch_io import (layout_from_torch, load_torch,
                                       save_torch, snapshot_torch)
from repro_torch.distrib.rules import RuleTable, local_box, rules_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train.elastic import Phase, run_phases
from repro_torch.train.loop import (SimulatedPreemption, TorchTrainer,
                                    TrainerConfig)
from repro_torch.train.optim import AdamW
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import (init_train_state, make_train_step,
                                    shard_state)

STEP = 3
RULES = RuleTable(table={"embed": "data", "mlp": "model",
                         "both": ("data", "model"), "batch": "data"})
# name -> (shape, logical axes)
SPECS = {
    "w_f32": ((8, 12), ("embed", "mlp")),
    "w_bf16": ((16, 4), ("both", None)),
    "ids_i32": ((4, 8), (None, "mlp")),
    "norm": ((6,), ("embed",)),          # 6 does not divide 4: replicated
    "bias": ((12,), (None,)),            # replicated on every mesh
    "step": ((), ()),
}


def full_state(seed: int = 0) -> dict[str, torch.Tensor]:
    """The state every process holds whole before sharding it."""
    rng = np.random.default_rng(seed)
    f32 = lambda shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    return {"w_f32": f32((8, 12)),
            "w_bf16": f32((16, 4)).to(torch.bfloat16),
            "ids_i32": torch.from_numpy(
                rng.integers(-1000, 1000, (4, 8)).astype(np.int32)),
            "norm": f32((6,)),
            "bias": f32((12,)),
            "step": torch.tensor(7, dtype=torch.int32)}


def shardings(mesh) -> dict:
    return {name: RULES.sharding_for(mesh, axes, shape)
            for name, (shape, axes) in SPECS.items()}


def bits(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8) \
        .numpy().tobytes()


def _save(mesh_shape, store_dir) -> dict:
    """Save the sharded state at ``STEP`` from this mesh's processes;
    returns this process's ordinals, boxes and DTensor offsets."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    sh = shardings(mesh)
    st = shard_state(full_state(), mesh, sh)
    layout = layout_from_torch(st)
    ck = None
    if dist.get_rank() == 0:
        ck = TensorCheckpoint(DatasetStore(store_dir, "w"))
        ck.save_layout(layout)
    save_torch(ck, st, STEP)
    mine = snapshot_torch(layout, st)[0]
    boxes, offsets = {}, {}
    for name, t in st.items():
        box = local_box(t.shape, mesh, t.placements)
        boxes[name] = (box.start, box.stop)
        shape, off = compute_local_shape_and_global_offset(
            tuple(t.shape), mesh, t.placements)
        offsets[name] = (tuple(off), tuple(o + s for o, s in zip(off, shape)))
    return {"layout": layout, "boxes": boxes, "dtensor_boxes": offsets,
            "ordinals": {n: s.ordinals.tolist() for n, s in mine.items()},
            "placements": {n: str(tuple(t.placements)) for n, t in st.items()}}


def _load(mesh_shape, store_dir) -> dict:
    """Load ``STEP`` onto this mesh; per array, whether this process's
    shard equals its box of the state bit for bit, with its dtype."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    sh = shardings(mesh)
    full = full_state()
    target = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
              for k, v in full.items()}
    ck = (TensorCheckpoint(DatasetStore(store_dir, "r"))
          if dist.get_rank() == 0 else None)
    got = load_torch(ck, target, STEP, device="cpu", mesh=mesh, shardings=sh)
    out = {}
    for name, t in got.items():
        box = local_box(t.shape, mesh, t.placements)
        out[name] = {"bit_equal": bits(t.to_local())
                     == bits(full[name][box.slices()]),
                     "dtype": str(t.dtype), "box": (box.start, box.stop),
                     "placements_match": list(t.placements) == sh[name]}
    return out


def save_and_load(saves, loads) -> dict:
    """``saves``: (key, mesh shape, store dir); ``loads``: (key, mesh shape,
    store dir), run in that order on this process."""
    out = {}
    for key, mesh_shape, d in saves:
        out[("save",) + key] = _save(mesh_shape, d)
    for key, mesh_shape, d in loads:
        out[("load",) + key] = _load(mesh_shape, d)
    return out


# ------------------------------------------------------------------ training
# the smoke model and schedule of tests/test_torch_train.py, at batch 8 so
# that every data rank of a 4-wide data axis takes whole rows
TRAIN_ARCH, TRAIN_SEQ, TRAIN_BATCH = "smollm_135m", 32, 8


def _train_step(mesh, dtype: str | None = None):
    cfg = get_smoke_config(TRAIN_ARCH)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    api = build_model(cfg)
    sched = functools.partial(warmup_cosine, base_lr=1e-3, warmup=2,
                              total=100)
    step = make_train_step(api, AdamW(), sched,
                           ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train"),
                           mesh=mesh, rules=rules_for(cfg.arch))
    return api, step


def _trainer(mesh, ckpt_dir, ckpt_every, store_factory=None):
    api, step = _train_step(mesh)
    data = SyntheticLM(api.cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    return TorchTrainer(
        step, data, TrainerConfig(str(ckpt_dir), ckpt_every=ckpt_every,
                                  log_every=1, store_factory=store_factory),
        device="cpu", init_state_fn=lambda: init_train_state(
            api, AdamW(), torch.Generator().manual_seed(0)))


def _full(state) -> dict[str, torch.Tensor]:
    """The whole arrays of a sharded state (a collective)."""
    return {k: t.full_tensor() for k, t in state.items()}


def _same_bits(a, b) -> list[str]:
    """Names of the arrays whose bits differ."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or bits(a[k]) != bits(b[k]))


def sharded_steps(mesh_shape, inits: dict, steps: int) -> dict:
    """From each dtype's initial state (``inits[dtype]``: whole arrays), run
    ``steps`` sharded steps on the batches of ``SyntheticLM(seed=0)``;
    returns each dtype's metrics per step and the whole final state."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    out = {}
    for dtype, init in inits.items():
        api, step = _train_step(mesh, dtype)
        state = shard_state(init, mesh, step.state_shardings)
        data = SyntheticLM(api.cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        metrics = []
        for i in range(steps):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[local_box(
                v.shape, mesh, step.batch_shardings[k]).slices()]))
                for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[dtype] = {"metrics": metrics, "state": _full(state)}
    return out


def train_and_save(mesh_shape, ckpt_dir, steps: int, ckpt_every: int):
    """A trainer on this mesh runs ``steps`` from a fresh init, saving every
    ``ckpt_every``; returns the whole final state."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    res = _trainer(mesh, ckpt_dir, ckpt_every).run(steps)
    return _full(res["state"])


def restore_full(mesh_shape, ckpt_dir) -> tuple[int, dict]:
    """``restore_latest`` onto this mesh; the step and the whole arrays,
    and whether each local shard is its box of them."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    state, start = _trainer(mesh, ckpt_dir, 0).restore_latest()
    full = _full(state)
    local_ok = all(bits(t.to_local()) == bits(
        full[k][local_box(t.shape, mesh, t.placements).slices()])
        for k, t in state.items())
    return start, full, local_ok


def kill_and_resume(mesh_shape, root) -> dict:
    """Run A straight to step 4; run B saving every 2 steps, preempted at 3;
    run C (a fresh trainer) restores the last committed step and runs to 4.
    Returns the arrays where C's final state differs from A's, on this
    process's shards and on the whole arrays."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    a = _trainer(mesh, f"{root}/a", 0)
    ra = a.run(4)
    b = _trainer(mesh, f"{root}/b", 2)
    try:
        b.run(4, fail_at=3)
        preempted = False
    except SimulatedPreemption:
        preempted = True
    c = _trainer(mesh, f"{root}/b", 2)
    state, start = c.restore_latest()
    rc = c.run(4, start_state=state, start_step=start)
    local = _same_bits({k: t.to_local() for k, t in ra["state"].items()},
                       {k: t.to_local() for k, t in rc["state"].items()})
    whole = _same_bits(_full(ra["state"]), _full(rc["state"]))
    losses = ({h["step"]: h["loss"] for h in a.history},
              {h["step"]: h["loss"] for h in c.history})
    return {"preempted": preempted, "restored": start,
            "local_differ": local, "whole_differ": whole,
            "losses": losses, "saved_by_b": b.save_log}


def four_processes(inits, steps, port_ckpt, fault_ckpt, kept) -> dict:
    """What tests/test_torch_mesh_train.py runs on 4 processes, mesh (2, 2):
    the sharded steps; a trainer saving steps 2 and 4; the crash (a run
    saving step 2 and keeping its state in ``kept``, then a run whose
    writer dies 4 store ops into the step-4 save)."""
    out = {"steps": sharded_steps((2, 2), inits, steps),
           "saved": train_and_save((2, 2), port_ckpt, 4, 2)}
    out["first"], out["crashed"] = run_phases([
        Phase((2, 2), 2, fault_ckpt, 0, keep=kept, arch=TRAIN_ARCH,
              ckpt_every=2),
        Phase((2, 2), 4, fault_ckpt, 2, arch=TRAIN_ARCH, ckpt_every=2,
              store_factory=functools.partial(FaultStore, kill_after_ops=4),
              expect_crash=True)])
    return out


def two_processes(jax_ckpt, resume_root, fault_ckpt, kept) -> dict:
    """What tests/test_torch_mesh_train.py runs on 2 processes: the
    reference's save restored on mesh (1, 2); kill and resume on (2, 1);
    the restart of the crashed run on (1, 2), checked against ``kept``."""
    return {"restored": restore_full((1, 2), jax_ckpt),
            "resume": kill_and_resume((2, 1), resume_root),
            "after_crash": run_phases([Phase(
                (1, 2), 2, fault_ckpt, 2, verify=kept, arch=TRAIN_ARCH,
                ckpt_every=2)])[0]}
