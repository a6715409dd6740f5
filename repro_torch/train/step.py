"""The train step over the flat train state, the counterpart of the JAX
package's ``train/step.py``: on one device, or sharded over a ``DeviceMesh``
of ``torch.distributed`` processes.

The train state is a FLAT dict, every leaf one named tensor:

    state = {"params/<name>": ..., "opt/<slot>/<name>": ..., "step": int32}

``make_train_step`` returns a :class:`TrainStep` whose call does one step:
value and gradient of ``api.loss``, the schedule, the optimizer update and
``step + 1``.  PyTorch runs eagerly, so there is nothing to compile; the
new state is made of new tensors (the old state is not updated in place).
As in the reference, the step runs under a ``MeshContext`` (on one device,
that of a (1, 1) mesh), which the MoE layer reads.

With a mesh, the state is a dict of DTensors on the placements of the
per-arch rule table (``state_shardings``), and the step computes the
one-device step's values: every process gathers the parameters, runs the
forward and backward on its data rank's rows of the global batch (the
kernels take the plain local tensors), averages the gradients over the
batch axes, and applies AdamW (elementwise) to its own shard of every
parameter and slot (Adafactor, which is not elementwise, is refused on a
mesh that shards the state).  Processes on the model axis repeat the same compute,
except in an expert-parallel MoE layer (``models/moe.py::moe_ffn_ep``):
its expert arrays are gathered over the other axes only, each process
runs its own experts, and their gradients (this process's experts,
averaged over the batch axes) are sliced to its shard; ``grad_norm`` sums
their squares over the model axis.  The reference leaves the rest of the
compute's partitioning to GSPMD, and only the state's layout is part of its
contract (and of the checkpoint).

``make_prefill_step`` and ``make_decode_step`` wrap ``api.prefill`` and
``api.decode_step`` in the same context, on one process (a (1, 1) mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib.context import MeshContext, use_mesh_context
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
#: the mesh of a step that runs on one device
ONE_DEVICE = {"data": 1, "model": 1}
#: the mesh axis experts are sharded over (the reference's ``ep_axis``)
EP_AXIS = "model"


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


def mesh_context_for(mesh, rules: RuleTable) -> MeshContext:
    """The context a step installs (the reference's builders' own): batch
    axes from ``rules``, experts over the model axis.  The reference's
    context also names the ZeRO-3 axes, over which its ``moe_ffn_ep``
    gathers the experts' embed dim; here the sharded step gathers them
    itself, so the layer needs none."""
    return MeshContext(mesh=mesh, dp_axes=rules.batch_axes, ep_axis=EP_AXIS,
                       rules=rules)


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

    def grad_norm(grads, model_group=None, split=()):
        """The 2-norm of all gradients; the squares of the arrays in
        ``split`` (each process holds its own part) are summed over
        ``model_group`` first."""
        names = sorted(grads)
        terms = [torch.sum(grads[n].to(F32) ** 2) for n in names]
        parts = [i for i, n in enumerate(names) if n in split]
        if model_group is not None and parts:
            summed = torch.stack([terms[i] for i in parts])
            dist.all_reduce(summed, group=model_group)
            for j, i in enumerate(parts):
                terms[i] = summed[j]
        return torch.sqrt(sum(terms))

    abstract_state = {n: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                     device="meta")
                      for n, s in specs.items()}
    b_specs = api.input_specs(shape)
    rules = rules or rules_for(api.cfg.arch)
    ctx = mesh_context_for(ONE_DEVICE if mesh is None else mesh, rules)

    def in_context(fn):
        def run(state, batch):
            with use_mesh_context(ctx):
                return fn(state, batch)
        return run

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

        return TrainStep(fn=in_context(step_fn), abstract_state=abstract_state,
                         abstract_batch=b_specs)

    st_sh = state_shardings(mesh, rules, specs)
    sizes = mesh_shape(mesh)
    if not optimizer.elementwise and any(
            p.is_shard() and n > 1 for pl in st_sh.values()
            for p, n in zip(pl, sizes.values())):
        # its scale and clip reduce over whole parameters (or leading
        # slices), which a process's shard does not hold
        raise NotImplementedError(
            f"{optimizer.name} on a mesh that shards the state: the "
            f"sharded step applies the optimizer to each process's shard, "
            f"which only an elementwise optimizer allows")
    b_sh = batch_shardings(mesh, rules, b_specs)
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

    # the expert arrays an expert-parallel layer takes as this process's
    # experts: gathered over every axis but the model axis
    moe = api.cfg.moe
    split = ({n for n, s in api.param_specs.items() if "experts" in s.axes}
             if moe is not None and moe.impl == "ep" else set())
    model_group = mesh.get_group(EP_AXIS) if sizes[EP_AXIS] > 1 else None

    def expert_placements(placements):
        names = list(sizes)
        return [p if names[i] == EP_AXIS else Replicate()
                for i, p in enumerate(placements)]

    def gather(name, p):
        if name not in split:
            return p.full_tensor()
        return p.redistribute(placements=expert_placements(p.placements)
                              ).to_local()

    def own(name, g, p):
        """This process's shard of gradient ``g`` of parameter ``p``."""
        box = local_box(p.shape, mesh, p.placements)
        if name not in split:
            return g[box.slices()]
        held = local_box(p.shape, mesh, expert_placements(p.placements))
        return g[tuple(slice(a - h, b - h) for a, b, h in
                       zip(box.start, box.stop, held.start))]

    def sharded_step_fn(state, batch):
        params, opt, step = _split_state(state)
        full = {n: gather(n, p) for n, p in params.items()}
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
            owned = {n: own(n, grads[n], params[n]) for n in names}
            new_params, new_opt = optimizer.update(
                {n: p.to_local() for n, p in params.items()}, owned,
                {k: v.to_local() for k, v in opt.items()}, lr, local_step)
            new_state = _join_state(
                {n: from_local(t, mesh, params[n].placements,
                               params[n].shape)
                 for n, t in new_params.items()},
                {k: from_local(t, mesh, opt[k].placements, opt[k].shape)
                 for k, t in new_opt.items()},
                from_local(local_step + 1, mesh, step.placements, ()))
            gnorm = grad_norm(grads, model_group, split)
        out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        out_metrics.update(metrics)
        return new_state, out_metrics

    return TrainStep(fn=in_context(sharded_step_fn), abstract_state=abstract_state,
                     abstract_batch=b_specs, mesh=mesh, state_shardings=st_sh,
                     batch_shardings=b_sh)


# ------------------------------------------------------------------ serving
@dataclasses.dataclass
class ServeStep:
    """``fn(*args)`` under the step's ``MeshContext`` (``ctx``)."""
    fn: Callable
    ctx: MeshContext

    def __call__(self, *args):
        with use_mesh_context(self.ctx):
            return self.fn(*args)


def _serve_context(api: TorchModelApi, mesh) -> MeshContext:
    mesh = ONE_DEVICE if mesh is None else mesh
    if math.prod(mesh_shape(mesh).values()) != 1:
        raise NotImplementedError(
            f"serving on a mesh of {mesh_shape(mesh)}: the sharded prefill "
            f"and decode steps are not ported (ROADMAP Queue 1 item 4, the "
            f"serve launcher's mesh path)")
    return mesh_context_for(mesh, rules_for(api.cfg.arch))


def make_prefill_step(api: TorchModelApi, shape: ShapeConfig,
                      cache_len: int | None = None, *, mesh=None
                      ) -> ServeStep:
    """prefill(params, batch) -> (logits, cache of ``cache_len`` or
    ``shape.seq_len`` positions), on one process (``mesh`` of one device or
    None)."""
    Smax = cache_len or shape.seq_len
    return ServeStep(fn=lambda params, batch: api.prefill(params, batch, Smax),
                     ctx=_serve_context(api, mesh))


def make_decode_step(api: TorchModelApi, *, mesh=None) -> ServeStep:
    """decode(params, cache, batch) -> (logits, cache): one new token per
    sequence against the cache, on one process."""
    return ServeStep(fn=api.decode_step, ctx=_serve_context(api, mesh))
