"""Mixture-of-Experts FFN, the counterpart of the JAX package's
``models/moe.py``: two implementations.

``moe_ffn`` (dense dispatch): GShard-style one-hot dispatch/combine
einsums, O(B*S*E*C) memory.  It is the oracle the EP path is held to.

``moe_ffn_ep`` (expert-parallel): the production path, over the processes
of a ``DeviceMesh``.  Activations are replicated over the ``model`` axis,
so every model shard routes the same tokens, keeps the choices that hit its
own experts, puts them into a capacity buffer by sorted position-in-expert,
runs its experts, gathers the results back and sums them over the model
axis.  Where the reference's body runs under ``shard_map``, this one runs
on every process with the boundaries of ``distrib/tensor_parallel.py``: the
replicated tokens and gates are copied onto the model axis after routing
(their gradients summed over it), the partial outputs are reduced from it,
and the aux loss's fractions are averaged over the batch axes.

No step accumulates through atomics, so a card repeats it bit for bit
under deterministic algorithms: kept choices go to unique slots of the
capacity buffer (the buffer is gathered from the choices, not scattered
into with ``.add``), and each token's ``top_k`` outputs are gathered back
into ``[T, top_k]`` and summed over ``k``.  The reference adds them into
the token's row one by one (``.at[tok].add``), so bf16 outputs differ from
it by the rounding of that sum (its f32 sum is the same up to order).

Experts that do not divide the model axis are padded (zero weights,
router-masked) upstream; the EP path only sees the padded count.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distrib.collectives import mean_over_groups
from repro_torch.distrib.tensor_parallel import (copy_to_group,
                                                 reduce_from_group)
from repro_torch.distrib.rules import mesh_shape

F32 = torch.float32
#: calls of ``moe_ffn_ep`` since the count was last reset (callers set it
#: to 0 and read it, to see that a path ran the EP layer)
calls = 0


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties toward the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _masked_probs(logits: torch.Tensor, num_real: int | None):
    E = logits.shape[-1]
    if num_real is not None and num_real < E:
        pad = torch.arange(E, device=logits.device) >= num_real
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    return torch.softmax(logits, dim=-1)


def _renorm(gates: torch.Tensor) -> torch.Tensor:
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25, num_real: int | None = None,
            mesh=None, dp_axes: tuple[str, ...] = ("data",)):
    """x [B, S, D]; router_w [D, E]; experts w_gate/w_up [E, D, F],
    w_down [E, F, D].  Returns (y [B, S, D], aux_loss scalar).
    ``num_real`` masks router-padded phantom experts (< E).  With a
    ``mesh`` whose ``dp_axes`` split the batch, ``x`` is this process's
    rows, and the aux loss's fractions are averaged over those axes
    before their product, as over the reference's global batch."""
    B, S, D = x.shape
    E = router_w.shape[-1]
    C = max(1, int(S * top_k / E * capacity_factor))
    dev = x.device

    probs = _masked_probs(x.to(F32) @ router_w.to(F32), num_real)  # [B,S,E]
    gates, ids = _top_k(probs, top_k)                              # [B,S,k]
    gates = _renorm(gates)

    # GShard position-in-expert via k cumsum passes over the sequence
    dispatch = torch.zeros((B, S, E, C), dtype=x.dtype, device=dev)
    combine = torch.zeros((B, S, E, C), dtype=F32, device=dev)
    fill = torch.zeros((B, E), dtype=torch.int64, device=dev)
    slots = torch.arange(C, device=dev)
    for j in range(top_k):
        onehot_e = F.one_hot(ids[..., j], E)                       # [B,S,E]
        pos = fill[:, None, :] + torch.cumsum(onehot_e, dim=1) - onehot_e
        pos = pos * onehot_e                         # position where routed
        keep = (onehot_e > 0) & (pos < C)
        # jax.nn.one_hot: a position past C is an all-zero row
        pos_oh = ((pos[..., None] == slots).to(x.dtype)
                  * keep[..., None].to(x.dtype))
        dispatch = dispatch + pos_oh * onehot_e[..., None].to(x.dtype)
        combine = combine + (pos_oh.to(F32) * onehot_e[..., None].to(F32)
                             * gates[..., j][..., None, None])
        fill = fill + onehot_e.sum(dim=1)

    # dispatch tokens -> expert buffers [E, B, C, D]
    xe = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    h = F.silu(torch.einsum("ebcd,edf->ebcf", xe, w_gate)) \
        * torch.einsum("ebcd,edf->ebcf", xe, w_up)
    ye = torch.einsum("ebcf,efd->ebcd", h, w_down)
    y = torch.einsum("bsec,ebcd->bsd", combine.to(x.dtype), ye)

    # Switch-style load-balance aux loss
    frac_tokens = F.one_hot(ids, E).to(F32).sum(2).mean(dim=(0, 1)) / top_k
    frac_probs = probs.mean(dim=(0, 1))
    if mesh is not None:
        groups, dp = _batch_groups(mesh, dp_axes)
        frac_tokens = mean_over_groups(frac_tokens, groups, dp)
        frac_probs = mean_over_groups(frac_probs, groups, dp)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return y, aux


# ===================================================================== EP path
def _route(x_flat, router_w, *, top_k: int, num_real: int):
    """Shared routing: returns (gates [T,k] f32, ids [T,k] int64, probs
    [T,E] f32)."""
    probs = _masked_probs(x_flat.to(F32) @ router_w.to(F32), num_real)
    gates, ids = _top_k(probs, top_k)
    return _renorm(gates), ids, probs


def _group(mesh, sizes: dict, axis: str):
    """The process group of ``axis``, or None where it has one process."""
    return mesh.get_group(axis) if sizes[axis] > 1 else None


def _batch_groups(mesh, dp_axes) -> tuple[list, int]:
    """The groups of the batch axes with more than one process, and the
    product of the batch axes' sizes."""
    sizes = mesh_shape(mesh)
    groups = [g for g in (_group(mesh, sizes, a) for a in dp_axes)
              if g is not None]
    return groups, math.prod(sizes[a] for a in dp_axes)


def _coordinate(mesh, sizes: dict, axis: str) -> int:
    return mesh.get_local_rank(axis) if sizes[axis] > 1 else 0


def _ep_body(x, router_w, w_gate, w_up, w_down, *, top_k: int,
             capacity: int, num_real: int, my_lo: int, model_group,
             dp_groups: list, dp: int):
    """One process's share.  x [B_loc, S, D] — its rows of the batch,
    replicated over the model axis; w_* [E_loc, D, F] / [E_loc, F, D] —
    its experts."""
    B, S, D = x.shape
    E_loc = w_gate.shape[0]
    x_flat = x.reshape(B * S, D)
    T = B * S
    N = T * top_k
    dev = x.device

    gates, ids, probs = _route(x_flat, router_w, top_k=top_k,
                               num_real=num_real)

    # ---- keep only choices routed to my experts -------------------------
    local_e = ids.reshape(N) - my_lo
    mine = (local_e >= 0) & (local_e < E_loc)
    key = torch.where(mine, local_e, torch.full_like(local_e, E_loc))

    # ---- position-in-expert via a stable sort (jax's sort_key_val) -------
    key_s, perm = torch.sort(key, stable=True)
    starts = torch.searchsorted(key_s, torch.arange(E_loc + 1, device=dev))
    pos = torch.arange(N, device=dev) - starts[key_s]
    keep_s = (key_s < E_loc) & (pos < capacity)
    slot_s = torch.where(keep_s, key_s * capacity + pos,
                         torch.full_like(pos, E_loc * capacity))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(N, device=dev)
    slot, keep = slot_s[inv], keep_s[inv]          # back in choice order

    # the replicated tokens and gates meet this shard's experts here
    x_c = copy_to_group(x_flat, model_group)
    gates_c = copy_to_group(gates, model_group)

    # ---- dispatch: each slot gathers the choice that fills it ------------
    # slot (e, p) holds sorted choice starts[e] + p when p < counts[e]; a
    # slot no choice fills reads the zero row N
    i = starts[:E_loc, None] + torch.arange(capacity, device=dev)[None, :]
    filled = i < starts[1:, None]
    choice = torch.where(filled, perm[i.clamp(max=N - 1)],
                         torch.full_like(i, N)).reshape(-1)
    x_rep = x_c[:, None, :].expand(T, top_k, D).reshape(N, D)
    src = torch.cat([x_rep, x_rep.new_zeros(1, D)])
    xe = torch.index_select(src, 0, choice).reshape(E_loc, capacity, D)

    # ---- expert FFN -------------------------------------------------------
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    ye = torch.bmm(h, w_down).reshape(E_loc * capacity, D)

    # ---- combine: gather back in [T, top_k], weight by gates, sum over k,
    # then over the model axis
    ye_pad = torch.cat([ye, ye.new_zeros(1, D)])
    weight = (gates_c.reshape(N) * keep.to(F32)).to(ye.dtype)
    vals = torch.index_select(ye_pad, 0, slot) * weight[:, None]
    y_flat = vals.reshape(T, top_k, D).sum(dim=1)
    y = reduce_from_group(y_flat.reshape(B, S, D), model_group)

    # ---- aux loss (identical across the model axis; averaged over the
    # batch axes) ----------------------------------------------------------
    real = torch.arange(num_real, device=dev)
    frac_tokens = (ids[..., None] == real).to(F32).sum(1).mean(dim=0)
    frac_probs = probs[:, :num_real].mean(dim=0)
    # global means BEFORE the product (E[X]E[Y], matching the oracle's
    # global-batch statistics), not a mean of per-shard products
    frac_tokens = mean_over_groups(frac_tokens, dp_groups, dp)
    frac_probs = mean_over_groups(frac_probs, dp_groups, dp)
    aux = num_real * torch.sum(frac_tokens / top_k * frac_probs)
    return y, aux


def moe_ffn_ep(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               capacity_factor: float, num_real: int, mesh,
               dp_axes: tuple[str, ...] = ("data",),
               ep_axis: str = "model"):
    """Expert-parallel MoE FFN on this process of ``mesh`` (a
    ``DeviceMesh``; for a mesh of one process also a ``{axis: 1}``
    mapping).

    x [B_loc, S, D]: this process's rows of the batch (sharded over
    ``dp_axes``, replicated over ``ep_axis``); router_w [D, E] whole;
    w_* this process's experts, [E / ep, D, F] / [E / ep, F, D], their
    embed dim whole: where the reference gathers the ZeRO-3 shards of the
    embed dim inside its ``shard_map``, the sharded step gathers them before
    the forward (``train/step.py``).  Returns (y [B_loc, S, D], aux scalar,
    the same on every process)."""
    global calls
    B, S, D = x.shape
    E = router_w.shape[-1]
    sizes = mesh_shape(mesh)
    ep = sizes[ep_axis]
    if E % ep != 0:
        raise ValueError(f"{E} experts not divisible by {ep_axis}={ep}")
    if w_gate.shape[0] * ep != E:
        raise ValueError(f"w_gate holds {w_gate.shape[0]} experts: expected "
                         f"this process's {E // ep} of {E}")
    dp = math.prod(sizes[a] for a in dp_axes)
    # x holds B_loc = B // dp rows: the reference's (B // dp) * S
    t_loc = max(1, B * S)
    capacity = max(1, int(math.ceil(t_loc * top_k / E * capacity_factor)))
    calls += 1
    return _ep_body(
        x, router_w, w_gate, w_up, w_down, top_k=top_k, capacity=capacity,
        num_real=num_real,
        my_lo=_coordinate(mesh, sizes, ep_axis) * (E // ep),
        model_group=_group(mesh, sizes, ep_axis),
        dp_groups=_batch_groups(mesh, dp_axes)[0], dp=dp)
