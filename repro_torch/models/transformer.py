"""Decoder-only LM family: GQA, qk-norm, softcaps,
local/global alternation, RoPE / M-RoPE, tied or untied embeddings, token
or embeddings input, optional MoE FFN — the counterpart of the JAX
package's ``models/transformer.py`` (smollm-135m, gemma2-2b, qwen3-1.7b/4b,
qwen2-vl-7b's backbone, granite-moe).

Parameters keep the reference's stacked ``[L, ...]`` layout; where the
reference scans over layers, this runs a Python loop over the per-layer
slices, and where it wraps a layer (or a group of layers) in
``jax.checkpoint``, this uses ``torch.utils.checkpoint``.  An MoE FFN runs
the expert-parallel ``moe_ffn_ep`` when its config asks for it and a step
builder has installed a ``MeshContext``, else the dense one-hot ``moe_ffn``,
as in the reference.

Where the sharded train or prefill step splits the compute over the model
axis (the context's ``ModelAxis``), each activation lies where the
reference's ``shard_hint`` puts it (the rule table: heads, kv heads, the
MLP hidden and the vocab on ``model``; see :class:`_Split`).  The
products whose weight is stored split as their activation is run on this
process's part of the weight (:func:`split_params`: the step hands those
over unsplit on ``model``, every other parameter whole): q, k and v on
this process's heads, the attention on its heads, ``wo`` and ``w_down``
row-split with their partial sums reduced by the residual's hint, the
embedding looked up in this process's vocab range and reduced, and the
loss and the prefill's logits vocab-parallel.  A value held whole that
feeds split work enters through ``copy_to_group``, so its gradient sums
the processes' parts.  With no model axis every split is off and the
functions run the one-device ops.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.context import (mesh_context, model_axis,
                                         model_split, shard_hint, split_of,
                                         use_mesh_context)
from repro_torch.distrib.tensor_parallel import (copy_to_group,
                                                 gather_from_group,
                                                 split_to_group)
from repro_torch.kernels.flash_attention.ops import flash_attention_vjp
from repro_torch.models.api import (
    BatchSpec,
    ParamSpec,
    TorchModelApi,
    token_batch_specs,
)
from repro_torch.models.layers import (
    apply_rope,
    chunked_softmax_xent,
    decode_attention,
    flash_attention_xla,
    mrope_angles,
    naive_attention,
    rms_norm,
    rope_angles,
    write_token,
)
from repro_torch.models import moe as moe_lib

F32 = torch.float32

_LAYER_KEYS = ["ln1", "ln2", "wq", "wk", "wv", "wo"]
_FFN_KEYS = ["w_gate", "w_up", "w_down"]
_MOE_KEYS = ["router", "we_gate", "we_up", "we_down"]


# ------------------------------------------------------------- param specs
def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, Hq, KV, hd, Fd, V, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim_, cfg.d_ff, cfg.vocab,
                               cfg.num_layers)
    dt = cfg.dtype
    p: dict[str, ParamSpec] = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), dt),
        "final_norm": ParamSpec((D,), ("embed",), dt, init="zeros"),
        "ln1": ParamSpec((L, D), ("layers", "embed"), dt, init="zeros"),
        "ln2": ParamSpec((L, D), ("layers", "embed"), dt, init="zeros"),
        "wq": ParamSpec((L, D, Hq * hd), ("layers", "embed", "heads"), dt),
        "wk": ParamSpec((L, D, KV * hd), ("layers", "embed", "kv_heads"), dt),
        "wv": ParamSpec((L, D, KV * hd), ("layers", "embed", "kv_heads"), dt),
        "wo": ParamSpec((L, Hq * hd, D), ("layers", "heads", "embed"), dt),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((V, D), ("vocab", "embed"), dt)
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((L, hd), ("layers", None), dt, init="zeros")
        p["k_norm"] = ParamSpec((L, hd), ("layers", None), dt, init="zeros")
    if cfg.moe is not None:
        E, Fe = cfg.moe.num_experts_padded, cfg.moe.d_ff_expert
        p["router"] = ParamSpec((L, D, E), ("layers", "embed", None), dt)
        p["we_gate"] = ParamSpec((L, E, D, Fe),
                                 ("layers", "experts", "expert_in", "expert_mlp"), dt)
        p["we_up"] = ParamSpec((L, E, D, Fe),
                               ("layers", "experts", "expert_in", "expert_mlp"), dt)
        p["we_down"] = ParamSpec((L, E, Fe, D),
                                 ("layers", "experts", "expert_mlp", "expert_in"), dt)
    else:
        p["w_gate"] = ParamSpec((L, D, Fd), ("layers", "embed", "mlp"), dt)
        p["w_up"] = ParamSpec((L, D, Fd), ("layers", "embed", "mlp"), dt)
        p["w_down"] = ParamSpec((L, Fd, D), ("layers", "mlp", "embed"), dt)
    return p


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding-window size (0 = full attention)."""
    return [cfg.local_window if k == "local" else 0 for k in cfg.layer_kinds()]


def _layer_params(params, cfg: ModelConfig) -> list[dict[str, torch.Tensor]]:
    """Each layer's slices of the stacked per-layer parameters (one
    ``unbind`` per array, so the backward pass stacks the layers' gradients
    once)."""
    keys = (_LAYER_KEYS + (["q_norm", "k_norm"] if cfg.qk_norm else [])
            + (_MOE_KEYS if cfg.moe is not None else _FFN_KEYS))
    per_key = {k: params[k].unbind(0) for k in keys}
    return [{k: per_key[k][i] for k in keys} for i in range(cfg.num_layers)]


# ------------------------------------------------------ tensor parallelism
@dataclasses.dataclass(frozen=True)
class _Split:
    """What the installed context splits over the model axis, by the
    reference's hints, and where a product runs on this process's part of
    its weight (the weight stored split as the activation it gives or
    takes): ``q`` (q [B, S, Hq, hd] on heads, ``wq``'s columns), ``kv``
    (k and v on kv heads, ``wk``/``wv``'s columns), ``attn`` (the
    attention's heads: on whole kv heads, "kv"; on each kv head's group of
    query heads, "group"; else None, every head on every process),
    ``out`` (the attention output [B, S, Hq * hd] on its columns, ``wo``'s
    rows), ``mlp`` (the dense MLP's hidden, ``w_gate``/``w_up``'s columns
    and ``w_down``'s rows) and ``vocab`` (the logits on the vocab, the
    table's rows); ``group`` is the model axis's."""
    q: bool = False
    kv: bool = False
    attn: str | None = None
    out: bool = False
    mlp: bool = False
    vocab: bool = False
    group: object = None


#: no split: the one-device ops (no model axis)
NO_SPLIT = _Split()


def _split(cfg: ModelConfig) -> _Split:
    """The step's split under the installed context: the loss, the prefill
    and the decode step work it out once and hand it down."""
    ax = model_axis()
    if ax is None:
        return NO_SPLIT
    D, Hq, KV, hd, Fd, V, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim_, cfg.d_ff, cfg.vocab,
                               cfg.num_layers)

    def on(act_axes, act_shape, *weights):
        """The activation is split and each (axes, shape, dim) weight is
        stored split on that dim."""
        return model_split(act_axes, act_shape) is not None and all(
            model_split(a, w) == d for a, w, d in weights)

    attn = model_split(_QB_AXES, (1, 1, KV, Hq // KV, hd))
    return _Split(
        q=on(("batch", None, "heads", None), (1, 1, Hq, hd),
             (("layers", "embed", "heads"), (L, D, Hq * hd), 2)),
        kv=on(("batch", None, "kv_heads", None), (1, 1, KV, hd),
              (("layers", "embed", "kv_heads"), (L, D, KV * hd), 2)),
        attn={2: "kv", 3: "group"}.get(attn),
        out=on(("batch", None, "heads"), (1, 1, Hq * hd),
               (("layers", "heads", "embed"), (L, Hq * hd, D), 1)),
        mlp=cfg.moe is None and on(
            ("batch", None, "mlp"), (1, 1, Fd),
            (("layers", "embed", "mlp"), (L, D, Fd), 2),
            (("layers", "mlp", "embed"), (L, Fd, D), 1)),
        vocab=on(("batch", None, "vocab"), (1, 1, V),
                 (("vocab", "embed"), (V, D), 0)),
        group=ax.group)


def split_params(cfg: ModelConfig) -> set[str]:
    """The parameters the loss, the prefill and the decode step take as
    this process's part of their model split under the installed context
    (each as the step holds it, gathered over the other axes); they take
    every other parameter whole."""
    s = _split(cfg)
    names = ({"wq"} if s.q else set()) | ({"wk", "wv"} if s.kv else set())
    names |= ({"wo"} if s.out else set())
    names |= set(_FFN_KEYS) if s.mlp else set()
    if s.vocab:
        names |= {"embed"} if cfg.tie_embeddings else {"embed", "unembed"}
    return names


#: the reference's hints on the blocked attention's q and k/v blocks
#: (``flash_attention_xla``), on the [B, S, Hkv, G, hd] and [B, S, Hkv, hd]
#: views every attention path here takes them in
_QB_AXES = ("batch", None, "kv_heads", "heads", None)
_KB_AXES = ("batch", None, "kv_heads", None)


def _whole(x, group, dim: int, size: int):
    """``x``, gathered along ``dim`` where it holds a part of ``size``."""
    return x if x.shape[dim] == size else gather_from_group(x, group, dim)


# ------------------------------------------------------------ forward core
def _qkv(cfg: ModelConfig, x, lp, sin, cos, *, s: _Split = NO_SPLIT):
    """q [B, S, Hq, hd], k and v [B, S, Hkv, hd] of the layer, each this
    process's box by its hint."""
    B, S, _ = x.shape
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = rms_norm(x, lp["ln1"])
    hs = copy_to_group(h, s.group) if s.q or s.kv else h
    q = ((hs if s.q else h) @ lp["wq"]).reshape(B, S, -1, hd)
    k = ((hs if s.kv else h) @ lp["wk"]).reshape(B, S, -1, hd)
    v = ((hs if s.kv else h) @ lp["wv"]).reshape(B, S, -1, hd)
    q = shard_hint(q, ("batch", None, "heads", None), (B, S, Hq, hd))
    k = shard_hint(k, ("batch", None, "kv_heads", None), (B, S, KV, hd))
    v = shard_hint(v, ("batch", None, "kv_heads", None), (B, S, KV, hd))
    if cfg.qk_norm:
        # a norm weight applied to this process's heads: its gradient
        # sums the processes' parts
        q = rms_norm(q, lp["q_norm"] if q.shape[2] == Hq
                     else copy_to_group(lp["q_norm"], s.group))
        k = rms_norm(k, lp["k_norm"] if k.shape[2] == KV
                     else copy_to_group(lp["k_norm"], s.group))
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attention_heads(cfg: ModelConfig, s: _Split, q, k, v):
    """q, k, v on the attention's heads (``s.attn``): split on kv heads as
    their hints left them; or each kv head's group of query heads split
    (q gathered first, but under one kv head, whose group's part is the
    heads q's hint gave this process) beside k and v whole, whose
    gradients then sum the groups' parts; or every head whole."""
    B, S = q.shape[:2]
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = Hq // KV
    if s.attn == "group" and KV == 1:
        q = q.reshape(B, S, 1, -1, hd)
    else:
        if s.attn != "kv":
            q = _whole(q, s.group, 2, Hq)
        q = q.reshape(B, S, -1, G, hd)
    q = shard_hint(q, _QB_AXES, (B, S, KV, G, hd)).reshape(B, S, -1, hd)
    Sk = k.shape[1]
    k = shard_hint(k, _KB_AXES, (B, Sk, KV, hd))
    v = shard_hint(v, _KB_AXES, (B, Sk, KV, hd))
    if s.attn == "group":
        k, v = copy_to_group(k, s.group), copy_to_group(v, s.group)
    return q, k, v


def _attention_out(cfg: ModelConfig, s: _Split, out):
    """The attention output [B, S, Hq * hd] by its hint, from the
    attention's heads: this process's columns where ``wo``'s rows are
    split as they are, else whole."""
    B, S = out.shape[:2]
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    if s.attn == "group" and KV > 1:
        out = gather_from_group(out.reshape(B, S, KV, -1, hd), s.group, 3)
    out = shard_hint(out.reshape(B, S, -1), ("batch", None, "heads"),
                     (B, S, Hq * hd))
    return out if s.out else _whole(out, s.group, 2, Hq * hd)


def _attention(cfg: ModelConfig, x, lp, sin, cos, *, window: int,
               q_offset: int = 0, s: _Split = NO_SPLIT):
    B, S, D = x.shape
    q, k, v = _qkv(cfg, x, lp, sin, cos, s=s)
    qa, ka, va = _attention_heads(cfg, s, q, k, v)
    if cfg.attention_impl == "naive":
        out = naive_attention(qa, ka, va, causal=True, window=window,
                              softcap=cfg.attn_softcap, q_offset=q_offset)
    elif (cfg.attention_impl == "pallas"
          and cfg.layer_pattern == "all_global"):
        # the hand-written kernel (its plain version on CPU tensors) under
        # autograd; as in the reference it takes one static window, so it
        # engages for uniform-window patterns only
        out = flash_attention_vjp(qa, ka, va, True, 0, cfg.attn_softcap,
                                  cfg.attn_block_q, cfg.attn_block_k,
                                  int(q_offset))
    else:
        out = flash_attention_xla(qa, ka, va, causal=True, window=window,
                                  softcap=cfg.attn_softcap,
                                  block_q=cfg.attn_block_q,
                                  block_k=cfg.attn_block_k,
                                  q_offset=q_offset)
    out = _attention_out(cfg, s, out)
    y = shard_hint(out @ lp["wo"], ("batch", None, None), (B, S, D),
                   partial=s.out)
    return x + y, (k, v)


def _ffn(cfg: ModelConfig, x, lp, *, s: _Split = NO_SPLIT):
    """x + the layer's FFN of x, and the FFN's aux loss (0 when dense)."""
    B, S, D = x.shape
    h = rms_norm(x, lp["ln2"])
    if cfg.moe is not None:
        ctx = mesh_context()
        if cfg.moe.impl == "ep" and ctx is not None:
            y, aux = moe_lib.moe_ffn_ep(
                h, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                num_real=cfg.moe.num_experts, mesh=ctx.mesh,
                dp_axes=ctx.dp_axes, ep_axis=ctx.ep_axis)
        else:
            # under a step's context, the aux loss's fractions are
            # averaged over the batch axes (this process holds its rows)
            y, aux = moe_lib.moe_ffn(
                h, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                num_real=cfg.moe.num_experts,
                mesh=None if ctx is None else ctx.mesh,
                dp_axes=() if ctx is None else ctx.dp_axes)
    else:
        # column- then row-split over the model axis where s.mlp
        hs = copy_to_group(h, s.group) if s.mlp else h
        y = F.silu(hs @ lp["w_gate"]) * (hs @ lp["w_up"])
        if s.mlp:
            y = shard_hint(y, ("batch", None, "mlp"), (B, S, cfg.d_ff))
        y = y @ lp["w_down"]
        aux = torch.zeros((), dtype=F32, device=x.device)
    return x + shard_hint(y, ("batch", None, None), (B, S, D),
                          partial=s.mlp), aux


def _embed_scale(cfg: ModelConfig, x):
    # sqrt(d_model) rounded to x's dtype first, as the reference does
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=F32).to(x.dtype)


def _unembed(params):
    """[D, V]: the reference unembeds through a bf16 copy of the table,
    whatever the parameter dtype."""
    w = params.get("unembed", params["embed"])
    return w.to(torch.bfloat16).t()


def _logits(params, cfg: ModelConfig, x, *, s: _Split = NO_SPLIT):
    """The last position's logits [B, V] f32 (vocab-split products
    gathered over the model axis)."""
    hidden = rms_norm(x, params["final_norm"])
    logits = hidden[:, -1].float() @ _unembed(params).float()
    if s.vocab:
        logits = gather_from_group(logits, s.group, 1)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _angles(cfg: ModelConfig, positions):
    """RoPE (sin, cos) of positions [B, S], or M-RoPE's of [B, S, 3]."""
    if cfg.mrope:
        return mrope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                            cfg.mrope_sections())
    return rope_angles(positions, cfg.head_dim_, cfg.rope_theta)


def _embed_in(params, cfg: ModelConfig, batch, *, s: _Split = NO_SPLIT):
    """The input activations [B, S, D] and their positions.  Embeddings
    input (``input_mode="embeds"``): ``batch["embeds"]`` cast to the
    model's dtype, unscaled, and ``batch["positions"]`` as given ([B, S],
    or [B, S, 3] under M-RoPE).  Tokens: their embeddings (scaled) and
    positions [B, S].  The gather is ``index_select``, whose backward on a
    card is deterministic under ``torch.use_deterministic_algorithms``
    (advanced indexing accumulates repeated tokens' rows with atomics).
    With the vocab split over the model axis each process looks up the
    tokens of its rows of the table (zeros for the others) and the hint
    sums them, which is exact: one process holds each token's row."""
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
        return x, batch["positions"]
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed_scale(cfg, _lookup(params, cfg, tokens, s=s))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return x, positions


def _lookup(params, cfg: ModelConfig, tokens, *, s: _Split = NO_SPLIT):
    """The tokens' [B, S] rows of the table [B, S, D], unscaled (see
    ``_embed_in``)."""
    B, S = tokens.shape
    ids = tokens.reshape(-1).long()
    if not s.vocab:
        return torch.index_select(params["embed"], 0, ids).reshape(B, S, -1)
    part = split_of(cfg.vocab)
    ids = ids - part.start
    inside = (ids >= 0) & (ids < part.stop - part.start)
    x = torch.index_select(params["embed"], 0,
                           ids.clamp(0, part.stop - part.start - 1))
    return shard_hint(torch.where(inside[:, None], x, 0).reshape(B, S, -1),
                      ("batch", None, None), (B, S, cfg.d_model),
                      partial=True)


def _layer_spans(cfg: ModelConfig) -> list[tuple[int, int]]:
    """[lo, hi) layer ranges checkpointed together: groups of
    ``remat_group`` layers, then the non-dividing tail one layer each."""
    G, L = max(1, cfg.remat_group), cfg.num_layers
    if G > 1 and L >= G:
        n = L // G * G
        return ([(i, i + G) for i in range(0, n, G)]
                + [(i, i + 1) for i in range(n, L)])
    return [(i, i + 1) for i in range(L)]


def forward_hidden(params, cfg: ModelConfig, x, sin, cos, *, q_offset=0,
                   s: _Split = NO_SPLIT):
    """Run all layers; x [B, S, D] -> (final-normed hidden [B, S, D], aux
    loss).  Under autograd with ``cfg.remat``, each span of
    ``_layer_spans`` is checkpointed: its activations are recomputed in the
    backward pass (``remat_group = G > 1`` keeps one carry per G layers)."""
    windows = _layer_windows(cfg)
    layers = _layer_params(params, cfg)
    # the backward pass recomputes a checkpointed span on the autograd
    # engine's thread (a card's own), which does not see this thread's
    # context: each span installs the one its forward ran under
    ctx = mesh_context()

    def run(x, aux, lo, hi):
        with use_mesh_context(ctx):
            for i in range(lo, hi):
                x, _ = _attention(cfg, x, layers[i], sin, cos,
                                  window=windows[i], q_offset=q_offset, s=s)
                x, a = _ffn(cfg, x, layers[i], s=s)
                aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=F32, device=x.device)
    for lo, hi in _layer_spans(cfg):
        x, aux = (checkpoint(run, x, aux, lo, hi, use_reentrant=False)
                  if remat else run(x, aux, lo, hi))
    return rms_norm(x, params["final_norm"]), aux


# -------------------------------------------------------------------- loss
def loss_fn(params, cfg: ModelConfig, batch):
    s = _split(cfg)
    x, positions = _embed_in(params, cfg, batch, s=s)
    sin, cos = _angles(cfg, positions)
    hidden, aux = forward_hidden(params, cfg, x, sin, cos, s=s)
    total, count = chunked_softmax_xent(
        copy_to_group(hidden, s.group) if s.vocab else hidden,
        _unembed(params), batch["targets"], batch["mask"],
        chunk=cfg.vocab_chunk or min(512, hidden.shape[1]),
        softcap=cfg.logit_softcap,
        vocab=split_of(cfg.vocab) if s.vocab else None)
    xent = total / torch.clamp(count, min=1.0)
    return xent + 0.01 * aux, {"xent": xent, "aux": aux}


# ---------------------------------------------------------------- serving
def cache_specs(cfg: ModelConfig, B: int, Smax: int) -> dict[str, BatchSpec]:
    KV, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    return {
        "k": BatchSpec((L, B, Smax, KV, hd), cfg.dtype),
        "v": BatchSpec((L, B, Smax, KV, hd), cfg.dtype),
        "length": BatchSpec((), "int32"),
    }


def cache_axes(cfg: ModelConfig):
    """The cache's logical axes (the rule table shards them): the sequence
    dim is ``kv_seq``."""
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None),
            "length": ()}


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """Full-sequence forward; returns (last-token logits [B, V] f32, filled
    cache).  ``batch`` holds ``tokens`` [B, S], or ``embeds`` [B, S, D] and
    ``positions`` under embeddings input, on the parameters' device."""
    s = _split(cfg)
    x, positions = _embed_in(params, cfg, batch, s=s)
    B, S, _ = x.shape
    Smax = Smax or S
    dev = params["embed"].device
    dtype = getattr(torch, cfg.dtype)
    sin, cos = _angles(cfg, positions)
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.head_dim_)
    ks = torch.zeros(shape, dtype=dtype, device=dev)
    vs = torch.zeros(shape, dtype=dtype, device=dev)
    layers = _layer_params(params, cfg)
    for i, window in enumerate(_layer_windows(cfg)):
        lp = layers[i]
        x, (k, v) = _attention(cfg, x, lp, sin, cos, window=window, s=s)
        x, _ = _ffn(cfg, x, lp, s=s)
        # every kv head of the step's cache box (this process's heads
        # gathered where they are split)
        ks[i, :, :S] = _whole(k, s.group, 2, cfg.num_kv_heads)
        vs[i, :, :S] = _whole(v, s.group, 2, cfg.num_kv_heads)
    cache = {"k": ks, "v": vs,
             "length": torch.tensor(S, dtype=torch.int32, device=dev)}
    return _logits(params, cfg, x, s=s), cache


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token in, one token's logits out.

    batch: token [B, 1], pos [B] (tensors on the parameters' device); under
    embeddings input it may carry ``embeds`` [B, 1, D] and ``positions``
    instead, taken as prefill takes them (unscaled), while a token is
    embedded and scaled, as in the reference.  Under M-RoPE, positions
    [B, 1] feed all three streams.  ``cache["length"]`` is a 0-d tensor
    (all sequences in step) or a PER-SLOT [B] vector (the
    continuous-batching engine: each slot writes its own cache position).
    Unlike the reference, which returns a new
    cache, the new token's k/v are written into ``cache["k"]`` and
    ``cache["v"]`` IN PLACE; the returned dict shares those tensors and
    carries ``length + 1``.  Under the sharded decode step the cache is
    this process's shard of the ``kv_seq``-split cache (``write_token``,
    ``decode_attention``).

    Where the step splits the compute over the model axis (``_Split``, as
    the prefill does), the token is looked up in this process's vocab
    rows, q, k and v are computed on its heads, and only the one token's
    q, k and v [B, 1, H/m, hd] are gathered over the axis: the cache
    holds every head of this process's key range, so the
    sequence-parallel attention runs every head.  Its output's columns of
    this process's heads meet ``wo``'s rows, the MLP runs column-split
    (or on this process's experts), each partial reduced at the
    residual's hint, and the logits are vocab-split and gathered."""
    s = _split(cfg)
    if cfg.input_mode == "embeds" and "embeds" in batch:
        x, positions = _embed_in(params, cfg, batch, s=s)
    else:
        x = _embed_scale(cfg, _lookup(params, cfg, batch["token"], s=s))
        positions = batch["pos"][:, None]
    if cfg.mrope and positions.dim() == 2:
        positions = torch.stack([positions] * 3, dim=-1)
    sin, cos = _angles(cfg, positions)
    length = cache["length"]
    B, D = x.shape[0], cfg.d_model
    Hq, KV = cfg.num_heads, cfg.num_kv_heads
    layers = _layer_params(params, cfg)
    for i, window in enumerate(_layer_windows(cfg)):
        lp = layers[i]
        q, k, v = _qkv(cfg, x, lp, sin, cos, s=s)
        q, k, v = (_whole(q, s.group, 2, Hq), _whole(k, s.group, 2, KV),
                   _whole(v, s.group, 2, KV))
        kc, vc = cache["k"][i], cache["v"][i]          # views: [B, Smax, KV, hd]
        write_token(kc, k, length, entry="k")
        write_token(vc, v, length, entry="v")
        out = decode_attention(q, kc, vc, length + 1, window=window,
                               softcap=cfg.attn_softcap, entry="k")
        out = out.reshape(B, 1, -1)
        if s.out:
            out = split_to_group(out, s.group, 2)
        x = x + shard_hint(out @ lp["wo"], ("batch", None, None), (B, 1, D),
                           partial=s.out)
        x, _ = _ffn(cfg, x, lp, s=s)
    new_cache = {"k": cache["k"], "v": cache["v"], "length": length + 1}
    return _logits(params, cfg, x, s=s), new_cache


# ---------------------------------------------------------------- assembly
def build(cfg: ModelConfig) -> TorchModelApi:
    return TorchModelApi(
        cfg=cfg,
        param_specs=param_specs(cfg),
        prefill=lambda params, batch, Smax=None: prefill(params, cfg, batch,
                                                         Smax),
        decode_step=lambda params, cache, batch: decode_step(params, cfg,
                                                             cache, batch),
        cache_specs=lambda B, Smax: cache_specs(cfg, B, Smax),
        cache_axes=functools.partial(cache_axes, cfg),
        loss=lambda params, batch: loss_fn(params, cfg, batch),
        input_specs=functools.partial(token_batch_specs, cfg),
        split_params=functools.partial(split_params, cfg),
    )
