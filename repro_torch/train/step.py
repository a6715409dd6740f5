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
one-device step's values: every process gathers the parameters over the
axes other than ``model``, runs the forward and backward on its data
rank's rows of the global batch (the kernels take the plain local
tensors), averages the gradients over the batch axes, and applies the
optimizer to its own shard of every parameter and slot: AdamW element by
element, Adafactor with each of its reductions over a parameter's dims
summed over the mesh groups that split those dims (``update(...,
splits=)``).

Over the model axis, a family with tensor-parallel compute (the
transformer's, the RG-LRU hybrid's and whisper's ``api.split_params``)
splits its compute as the
reference's activation hints place it (``distrib/context.py``): the
parameters it names stay split over ``model`` (this process's heads, MLP
columns or rows, vocab rows), and each process computes on them; a
parameter stored split over ``model`` that its op uses whole is gathered
over ``model`` for the step (counted as ``"parameter"`` bytes by
``distrib/collectives.traffic``).  The expert-parallel MoE layer
(``models/moe.py::moe_ffn_ep``) takes its expert arrays so too.  A
gradient of such a parameter is this process's part on ``model`` already,
so it is sliced on the other axes only, and ``grad_norm`` sums its squares
over the model axis.  Every other family gathers every parameter whole and
repeats the compute over the model axis (xLSTM).  The reference leaves the
compute's partitioning to GSPMD; only the state's layout is part of its
contract (and of the checkpoint).

``make_prefill_step`` and ``make_decode_step`` wrap ``api.prefill`` and
``api.decode_step`` in the same context: on one process, or on a mesh with
the serving cache sharded by the rule table (``cache_shardings``: its
sequence dim on ``kv_seq``, the model axis).  The sharded prefill splits
its compute over the model axis as the train step does (or repeats it, for
the other families) and keeps each process's box of the cache; the
sharded decode computes on each process's cache shard and exchanges only
per-token results (the sequence-parallel ``decode_attention``'s
log-sum-exp combine).  A tensor-parallel family's decode splits its
products over the model axis as its prefill does (this process's heads,
MLP part and vocab rows, the one token's q, k and v gathered for the
attention; the RG-LRU step on this process's channels of its states;
whisper's cross-attention on its kv heads of the cross K/V); the other
families take every parameter whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ShapeConfig
from repro_torch.distrib.collectives import all_sum, gather_along
from repro_torch.distrib.context import (DimSplit, MeshContext, ModelAxis,
                                         use_mesh_context)
from repro_torch.distrib.rules import (
    RuleTable,
    batch_shardings,
    cache_shardings,
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


def mesh_context_for(mesh, rules: RuleTable,
                     api: TorchModelApi | None = None) -> MeshContext:
    """The context a step installs (the reference's builders' own): batch
    axes from ``rules``, experts over the model axis, and, for the step of
    a family with tensor-parallel compute (``api.split_params``) on a
    ``DeviceMesh`` whose model axis has several processes and carries no
    batch, that axis.  The reference's context also names the ZeRO-3 axes,
    over which its ``moe_ffn_ep`` gathers the experts' embed dim; here the
    sharded step gathers them itself, so the layer needs none."""
    sizes, model = mesh_shape(mesh), None
    if (api is not None and api.split_params is not None
            and getattr(mesh, "mesh_dim_names", None) is not None
            and sizes.get(EP_AXIS, 1) > 1 and EP_AXIS not in rules.batch_axes):
        model = ModelAxis(mesh.get_group(EP_AXIS), sizes[EP_AXIS],
                          mesh.get_local_rank(EP_AXIS))
    return MeshContext(mesh=mesh, dp_axes=rules.batch_axes, ep_axis=EP_AXIS,
                       rules=rules, model=model)


def local_params(api: TorchModelApi, ctx: MeshContext) -> frozenset[str]:
    """The parameters a step under ``ctx`` hands over as this process's
    part on the model axis (gathered over the other axes only): an
    expert-parallel layer's experts, and what a tensor-parallel family
    splits (``api.split_params``) where ``ctx`` has a model axis."""
    moe, names = api.cfg.moe, set()
    if moe is not None and moe.impl == "ep":
        names = {n for n, s in api.param_specs.items() if "experts" in s.axes}
    if ctx.model is not None:
        with use_mesh_context(ctx):
            names |= api.split_params()
    return frozenset(names)


def _model_only(mesh, placements) -> list:
    """``placements`` gathered over every mesh axis but the model axis."""
    names = list(mesh_shape(mesh))
    return [p if names[i] == EP_AXIS else Replicate()
            for i, p in enumerate(placements)]


def _gather(name: str, p, mesh, local: frozenset[str]) -> torch.Tensor:
    """What the forward on this process takes of DTensor parameter ``p``:
    its part on the model axis, gathered over the other axes, for a
    parameter in ``local``; else the whole array (a split over ``model``
    gathered as ``"parameter"`` bytes of the model group).  The other
    axes' gathers go through ``collectives.gather_along``, minor mesh axis
    first, as DTensor's ``redistribute`` would place them: its functional
    all-gather kills a process whose gloo group holds a card's tensors
    (a (4, 2) mesh sharing one card), where ``gather_along`` works."""
    names, sizes = list(mesh_shape(mesh)), list(mesh_shape(mesh).values())
    keep = _model_only(mesh, p.placements)
    t = p.to_local()
    for i in reversed(range(len(names))):
        pl = p.placements[i]
        if names[i] != EP_AXIS and pl.is_shard() and sizes[i] > 1:
            t = gather_along(t, mesh.get_group(names[i]), pl.dim,
                             kind="parameter")
    if name in local:
        return t
    for i, pl in enumerate(keep):
        if pl.is_shard() and sizes[i] > 1:
            t = gather_along(t, mesh.get_group(EP_AXIS), pl.dim,
                             kind="parameter")
    return t


def _param_splits(mesh, shardings, specs) -> dict[str, dict[int, list]]:
    """{param: {dim: groups}}: the mesh groups of more than one process
    that split each dim of each parameter (in mesh-dim order), for an
    optimizer that reduces over a parameter's dims.  Its factored slots
    must lie as the parameter does with the reduced dim dropped, as the
    rule tables place them; raises where one does not."""
    sizes, names = mesh_shape(mesh), list(mesh_shape(mesh))
    out = {}
    for key, pl in shardings.items():
        if not key.startswith("params/"):
            continue
        n = key[len("params/"):]
        split = {}
        for i, p in enumerate(pl):
            if p.is_shard() and sizes[names[i]] > 1:
                split.setdefault(p.dim, []).append(mesh.get_group(names[i]))
        out[n] = split
        ndim = len(specs[key].shape)
        for slot, drop in (("vr", ndim - 1), ("vc", ndim - 2)):
            got = shardings.get(f"opt/{slot}/{n}")
            if got is None:
                continue
            want = [p if not p.is_shard() or p.dim < drop
                    else (Shard(p.dim - 1) if p.dim > drop else Replicate())
                    for p in pl]
            if list(got) != want:
                raise NotImplementedError(
                    f"opt/{slot}/{n} lies on {list(got)}, not as {key} "
                    f"({list(pl)}) with dim {drop} dropped")
    return out


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
    # the parameters the forward takes as this process's part on the model
    # axis (``local_params``)
    local_params: frozenset = frozenset()

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
        # a parameter the loss does not reach (the table of a model fed
        # embeddings) gets a zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True,
                                    materialize_grads=True)
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
            summed = all_sum(torch.stack([terms[i] for i in parts]),
                             model_group)
            for j, i in enumerate(parts):
                terms[i] = summed[j]
        return torch.sqrt(sum(terms))

    abstract_state = {n: torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                     device="meta")
                      for n, s in specs.items()}
    b_specs = api.input_specs(shape)
    rules = rules or rules_for(api.cfg.arch)
    ctx = mesh_context_for(ONE_DEVICE if mesh is None else mesh, rules, api)

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
    # an optimizer that reduces over a parameter's dims (Adafactor) learns
    # which groups split them; AdamW updates each element alone
    opt_kw = ({} if optimizer.elementwise
              else {"splits": _param_splits(mesh, st_sh, specs)})
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

    local = local_params(api, ctx)
    model_group = mesh.get_group(EP_AXIS) if sizes[EP_AXIS] > 1 else None

    def own(name, g, p):
        """This process's shard of gradient ``g`` of parameter ``p``."""
        box = local_box(p.shape, mesh, p.placements)
        if name not in local:
            return g[box.slices()]
        held = local_box(p.shape, mesh, _model_only(mesh, p.placements))
        return g[tuple(slice(a - h, b - h) for a, b, h in
                       zip(box.start, box.stop, held.start))]

    def sharded_step_fn(state, batch):
        params, opt, step = _split_state(state)
        full = {n: _gather(n, p, mesh, local) for n, p in params.items()}
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
                {k: v.to_local() for k, v in opt.items()}, lr, local_step,
                **opt_kw)
            new_state = _join_state(
                {n: from_local(t, mesh, params[n].placements,
                               params[n].shape)
                 for n, t in new_params.items()},
                {k: from_local(t, mesh, opt[k].placements, opt[k].shape)
                 for k, t in new_opt.items()},
                from_local(local_step + 1, mesh, step.placements, ()))
            gnorm = grad_norm(grads, model_group, local)
        out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        out_metrics.update(metrics)
        return new_state, out_metrics

    return TrainStep(fn=in_context(sharded_step_fn), abstract_state=abstract_state,
                     abstract_batch=b_specs, mesh=mesh, state_shardings=st_sh,
                     batch_shardings=b_sh, local_params=local)


# ------------------------------------------------------------------ serving
#: the cache entries, and their dims, that the models' decode paths take
#: split (``distrib/context.py::cache_split``): k/v on the sequence and the
#: kv-head dims, whisper's cross K/V on kv heads, the RG-LRU states' width
DECODE_SPLITS = {"k": (2, 3), "v": (2, 3), "xk": (3,), "xv": (3,),
                 "h": (2,), "conv": (3,)}


@dataclasses.dataclass
class ServeStep:
    """``fn(*args)`` under the step's ``MeshContext`` (``ctx``).  A prefill
    on a ``DeviceMesh`` says where its arrays live: the batch (this
    process's rows of it) and the cache it returns (DTensors)."""
    fn: Callable
    ctx: MeshContext
    mesh: object = None
    batch_shardings: dict | None = None
    cache_shardings: dict | None = None

    def __call__(self, *args):
        with use_mesh_context(self.ctx):
            return self.fn(*args)


def _one_process(mesh) -> bool:
    """True for no mesh or a mapping of one device; raises for a mapping of
    several, which has no processes to serve on."""
    if mesh is None or getattr(mesh, "mesh_dim_names", None) is not None:
        return mesh is None
    if math.prod(mesh_shape(mesh).values()) > 1:
        raise ValueError(f"a mesh given as axis sizes {mesh_shape(mesh)} has "
                         f"no processes to serve on: pass a DeviceMesh")
    return True


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _batch_dim(axes) -> int | None:
    return axes.index("batch") if "batch" in axes else None


def _rows_entry(axes: dict) -> str:
    """A cache entry with a batch dim: the per-row outputs (the logits) lie
    over the processes as its rows do."""
    return min(k for k, a in axes.items() if _batch_dim(a) is not None)


def _row_placements(placements, batch_dim: int | None) -> list:
    """The placements of a per-row output [B, ...] whose rows lie as dim
    ``batch_dim`` of an array on ``placements`` lies."""
    return [Shard(0) if p.is_shard() and p.dim == batch_dim else Replicate()
            for p in placements]


def _params_once(mesh, local: frozenset[str]):
    """``full(params)``: every parameter as ``_gather`` gives it, gathered
    once for the params dict the step last saw (serving does not change
    its parameters)."""
    last = {}

    def full(params):
        if last.get("of") is not params:
            last.clear()
            last.update(of=params, full={n: _gather(n, p, mesh, local)
                                         for n, p in params.items()})
        return last["full"]
    return full


def make_prefill_step(api: TorchModelApi, shape: ShapeConfig,
                      cache_len: int | None = None, *, mesh=None,
                      rules: RuleTable | None = None) -> ServeStep:
    """prefill(params, batch) -> (logits [B, V] f32, cache of ``cache_len``
    or ``shape.seq_len`` positions).

    Without a mesh (or on a mapping of one device) the arrays are plain
    tensors.  On a ``DeviceMesh`` (with ``rules``, default
    ``rules_for(api.cfg.arch)``): the parameters are DTensors, the batch
    this process's rows; each process gathers the parameters, prefills
    its rows (the flash kernel on the card) and keeps the box of the cache
    that ``cache_shardings`` gives it.  The logits come out as a DTensor
    of rows, the cache as DTensors.  A tensor-parallel family splits the
    compute over the model axis as the train step does (``local_params``);
    the others repeat it (but an expert-parallel MoE layer's)."""
    Smax = cache_len or shape.seq_len
    rules = rules or rules_for(api.cfg.arch)
    ctx = mesh_context_for(ONE_DEVICE if mesh is None else mesh, rules, api)
    if _one_process(mesh):
        return ServeStep(fn=lambda params, batch: api.prefill(params, batch,
                                                              Smax), ctx=ctx)
    c_specs = api.cache_specs(shape.global_batch, Smax)
    axes = api.cache_axes()
    c_sh = cache_shardings(mesh, rules, c_specs, axes)
    full = _params_once(mesh, local_params(api, ctx))
    rows_of = _rows_entry(axes)
    rows = _row_placements(c_sh[rows_of], _batch_dim(axes[rows_of]))

    def own_box(name, t):
        """This process's box of cache entry ``t``, computed for its rows
        and, in every other dim, whole or (the prefill of a family that
        splits its compute over the model axis: whisper's cross K/V on
        this process's kv heads, the RG-LRU states on its channels)
        already this process's part of a dim the cache splits."""
        shape_, bdim = c_specs[name].shape, _batch_dim(axes[name])
        box = local_box(shape_, mesh, c_sh[name])
        if bdim is not None and t.shape[bdim] != box.shape[bdim]:
            raise ValueError(f"{name}: {t.shape[bdim]} rows prefilled, the "
                             f"cache's box holds {box.shape[bdim]}")
        for d, (n, whole, part) in enumerate(zip(t.shape, shape_,
                                                 box.shape)):
            if d != bdim and n not in (whole, part):
                raise ValueError(f"{name}: dim {d} of {n}, neither the "
                                 f"cache's {whole} nor its box's {part}")
        own = tuple(slice(None) if d == bdim or t.shape[d] != shape_[d]
                    else slice(a, b)
                    for d, (a, b) in enumerate(zip(box.start, box.stop)))
        return from_local(t[own].contiguous(), mesh, c_sh[name], shape_)

    def sharded_prefill(params, batch):
        logits, cache = api.prefill(full(params),
                                    {k: _local(v) for k, v in batch.items()},
                                    Smax)
        return (from_local(logits, mesh, rows,
                           (shape.global_batch, logits.shape[-1])),
                {k: own_box(k, t) for k, t in cache.items()})

    return ServeStep(fn=sharded_prefill, ctx=ctx, mesh=mesh,
                     batch_shardings=batch_shardings(
                         mesh, rules, api.input_specs(shape)),
                     cache_shardings=c_sh)


def decode_splits(api: TorchModelApi, mesh, cache) -> dict:
    """{entry: {dim: DimSplit}} of a cache of DTensors on ``mesh``: every
    dim but the batch one that a mesh axis of more than one process
    shards.  Raises where a model's decode does not take that split
    (``DECODE_SPLITS``)."""
    axes, sizes = api.cache_axes(), mesh_shape(mesh)
    names = list(sizes)
    out = {}
    for k, t in cache.items():
        bdim = _batch_dim(axes[k])
        over = [(p.dim, names[i]) for i, p in enumerate(t.placements)
                if p.is_shard() and p.dim != bdim and sizes[names[i]] > 1]
        if not over:
            continue
        dims = [d for d, _ in over]
        if len(set(dims)) < len(dims) or any(
                d not in DECODE_SPLITS.get(k, ()) for d in dims):
            raise NotImplementedError(
                f"{api.cfg.arch}: cache entry {k!r} sharded over {over} "
                f"(dim, mesh axis): the decode step splits "
                f"{DECODE_SPLITS.get(k, ())} of it, over one axis each")
        box = local_box(t.shape, mesh, t.placements)
        out[k] = {d: DimSplit(box.start[d], box.stop[d], int(t.shape[d]),
                              mesh.get_group(a)) for d, a in over}
    return out


def make_decode_step(api: TorchModelApi, *, mesh=None,
                     rules: RuleTable | None = None) -> ServeStep:
    """decode(params, cache, batch) -> (logits, cache): one new token per
    sequence against the cache.

    On a ``DeviceMesh`` the parameters and the cache are DTensors (the
    cache on ``cache_shardings``, as the prefill step returns it) and the
    batch is this process's rows.  Each process decodes its rows against
    the cache shard it holds (``decode_splits``, read by the models through
    the context): the sequence-parallel ``decode_attention`` and the
    width-split RG-LRU step exchange per-token results over the model
    axis, never a cache entry; a tensor-parallel family computes on this
    process's parts of the parameters it splits (``local_params``).
    Returns the logits as a DTensor of rows and the cache as DTensors on
    its placements."""
    rules = rules or rules_for(api.cfg.arch)
    ctx = mesh_context_for(ONE_DEVICE if mesh is None else mesh, rules, api)
    if _one_process(mesh):
        return ServeStep(fn=api.decode_step, ctx=ctx)
    full = _params_once(mesh, local_params(api, ctx))
    axes = api.cache_axes()
    rows_of = _rows_entry(axes)
    bdim = _batch_dim(axes[rows_of])

    def sharded_decode(params, cache, batch):
        split_ctx = dataclasses.replace(
            ctx, cache_splits=decode_splits(api, mesh, cache))
        with use_mesh_context(split_ctx):
            logits, new = api.decode_step(
                full(params), {k: v.to_local() for k, v in cache.items()},
                {k: _local(v) for k, v in batch.items()})
        return (from_local(logits, mesh, _row_placements(
                    cache[rows_of].placements, bdim),
                    (cache[rows_of].shape[bdim], logits.shape[-1])),
                {k: from_local(t, mesh, cache[k].placements, cache[k].shape)
                 for k, t in new.items()})

    return ServeStep(fn=sharded_decode, ctx=ctx, mesh=mesh)
