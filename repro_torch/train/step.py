"""The train step over the flat train state, the counterpart of the JAX
package's ``train/step.py``: on one device, or sharded over a ``DeviceMesh``
of ``torch.distributed`` processes.

The train state is a FLAT dict, every leaf one named tensor:

    state = {"params/<name>": ..., "opt/<slot>/<name>": ..., "step": int32}

``make_train_step`` returns a :class:`TrainStep` whose call does one step:
value and gradient of ``api.loss``, the schedule, the optimizer update and
``step + 1``.  PyTorch runs eagerly, so there is nothing to compile; the
new state is made of new tensors (the old state is not updated in place).

With a mesh, the state is a dict of DTensors on the placements of the
per-arch rule table (``state_shardings``), and the step computes the
one-device step's values: every process gathers the parameters, runs the
forward and backward on its data rank's rows of the global batch (the
kernels take the plain local tensors), averages the gradients over the
batch axes, and applies AdamW (elementwise) to its own shard of every
parameter and slot.  Processes on the model axis repeat the same compute:
the reference leaves the compute's partitioning to GSPMD, and only the
state's layout is part of its contract (and of the checkpoint).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib.rules import (
    RuleTable,
    batch_shardings,
    from_local,
    local_box,
    mesh_shape,
    rules_for,
)
from repro_torch.models.api import BatchSpec, ParamSpec, TorchModelApi

F32 = torch.float32


# --------------------------------------------------------------- state spec
def train_state_specs(api: TorchModelApi, optimizer) -> dict[str, ParamSpec]:
    """Flat ParamSpec table for the full train state (params + opt)."""
    out = {f"params/{n}": s for n, s in api.param_specs.items()}
    for k, s in optimizer.state_specs(api.param_specs).items():
        out[f"opt/{k}"] = s
    out["step"] = ParamSpec((), (), "int32", init="zeros")
    return out


def init_train_state(api: TorchModelApi, optimizer,
                     generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Fresh state on the generator's device: ``api.init`` parameters, zero
    optimizer slots and step 0."""
    params = api.init(generator)
    state = {f"params/{n}": v for n, v in params.items()}
    for k, v in optimizer.init(api.param_specs, generator.device).items():
        state[f"opt/{k}"] = v
    state["step"] = torch.zeros((), dtype=torch.int32, device=generator.device)
    return state


def state_shardings(mesh, rules: RuleTable, specs: dict[str, ParamSpec]):
    """name -> DTensor placements on ``mesh`` of every array of the state."""
    return {name: rules.sharding_for(mesh, spec.axes, spec.shape)
            for name, spec in specs.items()}


def shard_state(state: dict[str, torch.Tensor], mesh, shardings
                ) -> dict[str, torch.Tensor]:
    """DTensors of a state that every process holds whole and alike (made
    from one seed): each process keeps its local box of each array."""
    return {name: from_local(t[local_box(t.shape, mesh, shardings[name])
                               .slices()].contiguous(),
                             mesh, shardings[name], t.shape)
            for name, t in state.items()}


def _split_state(state):
    params = {k[len("params/"):]: v for k, v in state.items()
              if k.startswith("params/")}
    opt = {k[len("opt/"):]: v for k, v in state.items()
           if k.startswith("opt/")}
    return params, opt, state["step"]


def _join_state(params, opt, step):
    out = {f"params/{n}": v for n, v in params.items()}
    out.update({f"opt/{k}": v for k, v in opt.items()})
    out["step"] = step
    return out


# ------------------------------------------------------------------- train
@dataclasses.dataclass
class TrainStep:
    """``fn(state, batch)``; with a ``mesh`` the state is DTensors on
    ``state_shardings`` and the batch is this process's rows of the global
    batch (``batch_shardings`` says which: ``rules.local_box`` of the
    leading dim), as plain tensors."""
    fn: Callable                       # (state, batch) -> (state, metrics)
    abstract_state: dict[str, torch.Tensor]     # meta tensors (restore targets)
    abstract_batch: dict[str, BatchSpec]
    mesh: object = None                # DeviceMesh, or None for one device
    state_shardings: dict | None = None         # name -> placements
    batch_shardings: dict | None = None         # input name -> placements

    def __call__(self, state, batch):
        return self.fn(state, batch)


def make_train_step(api: TorchModelApi, optimizer, schedule,
                    shape: ShapeConfig, microbatches: int = 1, *,
                    mesh=None, rules: RuleTable | None = None) -> TrainStep:
    """``microbatches > 1`` runs gradient accumulation: the global batch is
    split on its leading dim, and the mean gradients accumulate in the GRAD
    DTYPE (bf16 for bf16 params), as the reference does; the metrics are
    then loss, lr and grad_norm only.  ``mesh`` (a ``DeviceMesh`` with axes
    ``("data", "model")``, or ``("pod", "data", "model")``) builds the
    sharded step over ``rules`` (default ``rules_for(api.cfg.arch)``)."""
    if api.loss is None:
        raise NotImplementedError(f"{api.cfg.arch}: training is not ported "
                                  f"for this family yet")
    specs = train_state_specs(api, optimizer)
    A = microbatches
    if shape.global_batch % max(A, 1):
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {A} microbatches")

    def value_and_grad(leaves, batch):
        loss, metrics = api.loss(leaves, batch)
        loss = loss.to(F32)
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), metrics, dict(zip(names, grads))

    def loss_and_grads(params, batch, device):
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        if A <= 1:
            loss, metrics, grads = value_and_grad(leaves, batch)
            return loss, {k: v.detach() for k, v in metrics.items()}, grads
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        loss = torch.zeros((), dtype=F32, device=device)
        for i in range(A):
            mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
                  for k, v in batch.items()}
            l, _, g = value_and_grad(leaves, mb)
            grads = {n: a + (g[n] / A).to(a.dtype) for n, a in grads.items()}
            loss = loss + l / A
        return loss, {}, grads

    def grad_norm(grads):
        return torch.sqrt(sum(torch.sum(grads[n].to(F32) ** 2)
                              for n in sorted(grads)))

    abstract_state = {n: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                     device="meta")
                      for n, s in specs.items()}
    b_specs = api.input_specs(shape)

    if mesh is None:
        def step_fn(state, batch):
            params, opt, step = _split_state(state)
            loss, metrics, grads = loss_and_grads(params, batch, step.device)
            with torch.no_grad():
                lr = schedule(step)
                new_params, new_opt = optimizer.update(params, grads, opt,
                                                       lr, step)
                new_state = _join_state(new_params, new_opt, step + 1)
                gnorm = grad_norm(grads)
            out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
            out_metrics.update(metrics)
            return new_state, out_metrics

        return TrainStep(fn=step_fn, abstract_state=abstract_state,
                         abstract_batch=b_specs)

    rules = rules or rules_for(api.cfg.arch)
    st_sh = state_shardings(mesh, rules, specs)
    b_sh = batch_shardings(mesh, rules, b_specs)
    sizes = mesh_shape(mesh)
    # the batch axes' groups, if the batch is sharded over any of them
    batch_sharded = any(p.is_shard() for p in next(iter(b_sh.values())))
    groups = [mesh.get_group(a) for a in rules.batch_axes
              if batch_sharded and sizes[a] > 1]
    n_batch = math.prod(sizes[a] for a in rules.batch_axes)

    def batch_mean(values: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each value's mean over the batch axes' processes: summed in f32
        in one flat buffer, then cast back to its own dtype."""
        if not groups:
            return values
        flat = torch.cat([v.reshape(-1).to(F32) for v in values])
        for g in groups:
            dist.all_reduce(flat, group=g)
        flat /= n_batch
        out, at = [], 0
        for v in values:
            out.append(flat[at:at + v.numel()].reshape(v.shape).to(v.dtype))
            at += v.numel()
        return out

    def sharded_step_fn(state, batch):
        params, opt, step = _split_state(state)
        full = {n: p.full_tensor() for n, p in params.items()}
        local_step = step.to_local()
        loss, metrics, grads = loss_and_grads(full, batch,
                                              local_step.device)
        names, mnames = sorted(grads), sorted(metrics)
        mean = batch_mean([loss] + [metrics[k] for k in mnames]
                          + [grads[n] for n in names])
        loss = mean[0]
        metrics = dict(zip(mnames, mean[1:1 + len(mnames)]))
        grads = dict(zip(names, mean[1 + len(mnames):]))
        with torch.no_grad():
            lr = schedule(local_step)
            own = {n: grads[n][local_box(params[n].shape, mesh,
                                         params[n].placements).slices()]
                   for n in names}
            new_params, new_opt = optimizer.update(
                {n: p.to_local() for n, p in params.items()}, own,
                {k: v.to_local() for k, v in opt.items()}, lr, local_step)
            new_state = _join_state(
                {n: from_local(t, mesh, params[n].placements,
                               params[n].shape)
                 for n, t in new_params.items()},
                {k: from_local(t, mesh, opt[k].placements, opt[k].shape)
                 for k, t in new_opt.items()},
                from_local(local_step + 1, mesh, step.placements, ()))
            gnorm = grad_norm(grads)
        out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        out_metrics.update(metrics)
        return new_state, out_metrics

    return TrainStep(fn=sharded_step_fn, abstract_state=abstract_state,
                     abstract_batch=b_specs, mesh=mesh, state_shardings=st_sh,
                     batch_shardings=b_sh)
