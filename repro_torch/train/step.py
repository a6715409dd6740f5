"""The train step over the flat train state, the counterpart of the JAX
package's ``train/step.py`` without meshes (one device; sharded steps come
with the port's meshes).

The train state is a FLAT dict, every leaf one named tensor:

    state = {"params/<name>": ..., "opt/<slot>/<name>": ..., "step": int32}

``make_train_step`` returns a :class:`TrainStep` whose call does one step:
value and gradient of ``api.loss``, the schedule, the optimizer update and
``step + 1``.  PyTorch runs eagerly, so there is nothing to compile; the
new state is made of new tensors (the old state is not updated in place).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ShapeConfig
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
    fn: Callable                       # (state, batch) -> (state, metrics)
    abstract_state: dict[str, torch.Tensor]     # meta tensors (restore targets)
    abstract_batch: dict[str, BatchSpec]

    def __call__(self, state, batch):
        return self.fn(state, batch)


def make_train_step(api: TorchModelApi, optimizer, schedule,
                    shape: ShapeConfig, microbatches: int = 1) -> TrainStep:
    """``microbatches > 1`` runs gradient accumulation: the global batch is
    split on its leading dim, and the mean gradients accumulate in the GRAD
    DTYPE (bf16 for bf16 params), as the reference does; the metrics are
    then loss, lr and grad_norm only."""
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

    def step_fn(state, batch):
        params, opt, step = _split_state(state)
        leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
        if A <= 1:
            loss, metrics, grads = value_and_grad(leaves, batch)
        else:
            grads = {n: torch.zeros_like(p) for n, p in params.items()}
            loss = torch.zeros((), dtype=F32, device=step.device)
            for i in range(A):
                mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
                      for k, v in batch.items()}
                l, _, g = value_and_grad(leaves, mb)
                grads = {n: a + (g[n] / A).to(a.dtype)
                         for n, a in grads.items()}
                loss = loss + l / A
            metrics = {}
        with torch.no_grad():
            lr = schedule(step)
            new_params, new_opt = optimizer.update(params, grads, opt, lr,
                                                   step)
            new_state = _join_state(new_params, new_opt, step + 1)
            gnorm = torch.sqrt(sum(torch.sum(grads[n].to(F32) ** 2)
                                   for n in sorted(grads)))
        out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        out_metrics.update({k: v.detach() for k, v in metrics.items()})
        return new_state, out_metrics

    return TrainStep(
        fn=step_fn,
        abstract_state={n: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                       device="meta")
                        for n, s in specs.items()},
        abstract_batch=api.input_specs(shape))
