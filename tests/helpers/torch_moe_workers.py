"""What the port's multi-process MoE tests run on every process of a mesh
(``repro_torch.launch.spawn.run_processes``; module-level functions, so
the spawned processes import them by name).  Imports torch and the port
only.

* ``ep_layer``: ``moe_ffn_ep`` on this process's share of seeded inputs
  (its rows of x, its experts' weights gathered over the data axis, as the
  sharded step passes them), with its gradients, as written, or with a
  planted fault in one of its autograd boundaries;
* ``sharded_steps``: the granite smoke EP variant's sharded train step;
* the restart phases of granite's EP state across process counts (through
  ``repro_torch.train.elastic``, whose phases build the smoke config by
  name: ``_ep_smoke`` makes the name give the EP variant).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
from helpers.torch_mesh_workers import _full, bits
from torch.distributed.tensor._utils import (
    compute_local_shape_and_global_offset)

from repro_torch.configs import canonical, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib import collectives
from repro_torch.distrib.rules import coords_of, local_box, rules_for
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import moe
from repro_torch.models.api import build_model
from repro_torch.train.data import SyntheticLM
from repro_torch.train import elastic
from repro_torch.train.elastic import Phase, run_phases
from repro_torch.train.loop import TorchTrainer, TrainerConfig
from repro_torch.train.optim import AdamW
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.step import (init_train_state, make_train_step,
                                    shard_state)

# ------------------------------------------------------------- the EP layer
# (B, S, D, E padded, F, top_k, num_real, capacity factor): 12 experts over
# a model axis of 2, 4 of them phantoms; the default capacity, so choices
# drop (capacity ceil(2 * 16 * 2 / 12 * 1.25) = 7 per expert and data rank)
EP_SHAPE = (4, 16, 32, 12, 16, 2, 8, 1.25)
EP_MESH = (2, 2)


def ep_inputs(seed: int = 0) -> list[np.ndarray]:
    """x, router, w_gate, w_up, w_down in f32 (the reference's test draws
    the same)."""
    B, S, D, E, Fd = EP_SHAPE[:5]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(D, E)).astype(np.float32),
            (rng.normal(size=(E, D, Fd)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, D, Fd)) * 0.1).astype(np.float32),
            (rng.normal(size=(E, Fd, D)) * 0.1).astype(np.float32)]


def ep_boxes(mesh_shape, coord) -> list[tuple[slice, ...]]:
    """This process's boxes of the five inputs: its data rank's rows of x,
    the whole router and its model rank's experts (the reference's in_specs
    P(data), P() and P(model, ...), the experts' embed dim gathered)."""
    (dp, ep), (d, m) = mesh_shape, coord
    B, E = EP_SHAPE[0], EP_SHAPE[3]
    rows = slice(d * B // dp, (d + 1) * B // dp)
    ex = slice(m * E // ep, (m + 1) * E // ep)
    return [(rows,), (slice(None),), (ex,), (ex,), (ex,)]


class _ScaledMean(torch.autograd.Function):
    """A planted fault: the batch-axes mean whose backward takes 1/n of the
    cotangent (the factor ``shard_map``'s pmean hides)."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        return collectives._MeanOverGroups.forward(ctx, x, groups, n)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _plant(fault: str | None):
    """Patch ``moe``'s boundaries for one planted fault; returns the undo."""
    saved = (moe.copy_to_group, moe.mean_over_groups)
    if fault == "router_not_reduced":
        top_k = EP_SHAPE[5]

        def copy(x, group):        # the gates [T, top_k] skip the sum
            return x if x.shape[-1] == top_k else saved[0](x, group)
        moe.copy_to_group = copy
    elif fault == "aux_mean_scaled":
        moe.mean_over_groups = (lambda x, groups, n: x if not groups
                                else _ScaledMean.apply(x, groups, n))
    elif fault is not None:
        raise ValueError(fault)

    def undo():
        moe.copy_to_group, moe.mean_over_groups = saved
    return undo


def ep_layer(faults=(None,)) -> dict:
    """y, aux and the gradients of this process's share of the global loss
    sum(y^2) + aux (its rows' squares and aux / dp: the step's
    convention, in which each batch process's loss holds the whole aux),
    for each planted fault (None: as written)."""
    mesh = make_debug_mesh(*EP_MESH, device_type="cpu")
    coord = tuple(coords_of(mesh).values())
    top_k, num_real, cf = EP_SHAPE[5:]
    boxes = ep_boxes(EP_MESH, coord)
    out = {"coord": coord}
    for fault in faults:
        undo = _plant(fault)
        try:
            t = [torch.from_numpy(np.ascontiguousarray(a[b]))
                 .requires_grad_(True)
                 for a, b in zip(ep_inputs(), boxes)]
            y, aux = moe.moe_ffn_ep(*t, top_k=top_k, capacity_factor=cf,
                                    num_real=num_real, mesh=mesh)
            loss = (y ** 2).sum() + aux / EP_MESH[0]
            grads = torch.autograd.grad(loss, t)
        finally:
            undo()
        out[fault] = {"y": y.detach().numpy(), "aux": float(aux),
                      "grads": [g.numpy() for g in grads]}
    return out


# ------------------------------------------------------- the sharded step
ARCH, SEQ, BATCH = "granite_moe_3b_a800m", 16, 8


def ep_config(dtype: str | None = None):
    """Granite's smoke config, EP variant (16 experts, 8 phantoms)."""
    cfg = get_smoke_config(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="ep"))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _sched():
    return functools.partial(warmup_cosine, base_lr=1e-3, warmup=2,
                             total=100)


def sharded_steps(mesh_shape, inits: dict, steps: int) -> dict:
    """From each dtype's initial state (whole arrays), ``steps`` sharded
    steps on the batches of ``SyntheticLM(seed=0)``; each dtype's metrics
    per step and the whole final state."""
    mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
    out = {}
    for dtype, init in inits.items():
        api = build_model(ep_config(dtype))
        step = make_train_step(api, AdamW(), _sched(),
                               ShapeConfig("t", SEQ, BATCH, "train"),
                               mesh=mesh, rules=rules_for(api.cfg.arch))
        state = shard_state(init, mesh, step.state_shardings)
        data = SyntheticLM(api.cfg.vocab, SEQ, BATCH, seed=0)
        metrics = []
        for i in range(steps):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v[local_box(
                v.shape, mesh, step.batch_shardings[k]).slices()]))
                for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        boxes = {}
        for k, t in state.items():
            shape, off = compute_local_shape_and_global_offset(
                tuple(t.shape), mesh, t.placements)
            box = local_box(t.shape, mesh, t.placements)
            boxes[k] = (box.start, box.stop) == (
                tuple(off), tuple(o + n for o, n in zip(off, shape)))
        out[dtype] = {"metrics": metrics, "state": _full(state),
                      "boxes_match": all(boxes.values()),
                      "expert_local": tuple(
                          state["params/we_gate"].to_local().shape)}
    return out


def mesh_case(inits: dict, steps: int) -> dict:
    """What tests/test_torch_moe_mesh.py runs on 4 processes, mesh (2, 2):
    the EP layer as written and with each planted fault, then the sharded
    steps."""
    return {"layer": ep_layer((None, "router_not_reduced",
                               "aux_mean_scaled")),
            "steps": sharded_steps(EP_MESH, inits, steps)}


# ------------------------------------------------ restarts across EP degrees
@contextlib.contextmanager
def _ep_smoke():
    """Within the block, the phases' ``get_smoke_config(ARCH)`` gives the
    EP variant."""
    saved = elastic.get_smoke_config
    elastic.get_smoke_config = (lambda arch: ep_config()
                                if canonical(arch) == ARCH else saved(arch))
    try:
        yield
    finally:
        elastic.get_smoke_config = saved


def _phase(mesh, steps, ckpt, start, ckpt_every=2, **kw):
    return Phase(mesh, steps, ckpt, start, arch=ARCH, seq=SEQ, batch=BATCH,
                 ckpt_every=ckpt_every, **kw)


def save_four(ckpt, kept, port_ckpt) -> dict:
    """4 processes, mesh (2, 2): train the EP variant 0 -> 2 saving step 2
    (the whole state kept in ``kept``); a trainer saving steps 2 and 4 into
    ``port_ckpt`` for the reference to restore."""
    with _ep_smoke():
        first = run_phases([_phase((2, 2), 2, ckpt, 0, keep=kept)])[0]
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    api = build_model(ep_config())
    step = make_train_step(api, AdamW(), _sched(),
                           ShapeConfig("t", SEQ, BATCH, "train"), mesh=mesh,
                           rules=rules_for(api.cfg.arch))
    tr = TorchTrainer(step, SyntheticLM(api.cfg.vocab, SEQ, BATCH, seed=0),
                      TrainerConfig(str(port_ckpt), ckpt_every=2,
                                    log_every=1),
                      device="cpu", init_state_fn=lambda: init_train_state(
                          api, AdamW(), torch.Generator().manual_seed(0)))
    return {"first": first, "saved": _full(tr.run(4)["state"])}


def restore_and_train(mesh_shape, ckpt, kept, jax_ckpt=None) -> dict:
    """Restore the 4 processes' step 2 on this mesh, bit-equal to ``kept``
    (``Phase.verify``), and train on to 4 without saving (so restarts on
    several meshes can share the store); with ``jax_ckpt``, also restore
    the reference's step 4 from it and return its whole arrays."""
    with _ep_smoke():
        out = {"phase": run_phases([_phase(mesh_shape, 4, ckpt, 2,
                                           ckpt_every=0, from_step=2,
                                           verify=kept)])[0]}
    if jax_ckpt is not None:
        mesh = make_debug_mesh(*mesh_shape, device_type="cpu")
        api = build_model(ep_config())
        step = make_train_step(api, AdamW(), _sched(),
                               ShapeConfig("t", SEQ, BATCH, "train"),
                               mesh=mesh, rules=rules_for(api.cfg.arch))
        tr = TorchTrainer(step, SyntheticLM(api.cfg.vocab, SEQ, BATCH, 0),
                          TrainerConfig(str(jax_ckpt), ckpt_every=0),
                          device="cpu", init_state_fn=lambda: None)
        state, start = tr.restore_latest()
        full = _full(state)
        out["jax"] = {"start": start, "state": full, "local_ok": all(
            bits(t.to_local()) == bits(full[k][local_box(
                t.shape, mesh, t.placements).slices()])
            for k, t in state.items())}
    return out
