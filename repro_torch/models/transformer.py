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
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.context import mesh_context, use_mesh_context
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


# ------------------------------------------------------------ forward core
def _qkv(cfg: ModelConfig, x, lp, sin, cos):
    B, S, _ = x.shape
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = rms_norm(x, lp["ln1"])
    q = (h @ lp["wq"]).reshape(B, S, Hq, hd)
    k = (h @ lp["wk"]).reshape(B, S, KV, hd)
    v = (h @ lp["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attention(cfg: ModelConfig, x, lp, sin, cos, *, window: int,
               q_offset: int = 0):
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, x, lp, sin, cos)
    if cfg.attention_impl == "naive":
        out = naive_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap, q_offset=q_offset)
    elif (cfg.attention_impl == "pallas"
          and cfg.layer_pattern == "all_global"):
        # the hand-written kernel (its plain version on CPU tensors) under
        # autograd; as in the reference it takes one static window, so it
        # engages for uniform-window patterns only
        out = flash_attention_vjp(q, k, v, True, 0, cfg.attn_softcap,
                                  cfg.attn_block_q, cfg.attn_block_k,
                                  int(q_offset))
    else:
        out = flash_attention_xla(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap,
                                  block_q=cfg.attn_block_q,
                                  block_k=cfg.attn_block_k,
                                  q_offset=q_offset)
    return x + out.reshape(B, S, -1) @ lp["wo"], (k, v)


def _ffn(cfg: ModelConfig, x, lp):
    """x + the layer's FFN of x, and the FFN's aux loss (0 when dense)."""
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
            y, aux = moe_lib.moe_ffn(
                h, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                num_real=cfg.moe.num_experts)
    else:
        y = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
        y = y @ lp["w_down"]
        aux = torch.zeros((), dtype=F32, device=x.device)
    return x + y, aux


def _embed_scale(cfg: ModelConfig, x):
    # sqrt(d_model) rounded to x's dtype first, as the reference does
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=F32).to(x.dtype)


def _unembed(params):
    """[D, V]: the reference unembeds through a bf16 copy of the table,
    whatever the parameter dtype."""
    w = params.get("unembed", params["embed"])
    return w.to(torch.bfloat16).t()


def _logits(params, cfg: ModelConfig, x):
    hidden = rms_norm(x, params["final_norm"])
    logits = hidden[:, -1].float() @ _unembed(params).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _angles(cfg: ModelConfig, positions):
    """RoPE (sin, cos) of positions [B, S], or M-RoPE's of [B, S, 3]."""
    if cfg.mrope:
        return mrope_angles(positions, cfg.head_dim_, cfg.rope_theta,
                            cfg.mrope_sections())
    return rope_angles(positions, cfg.head_dim_, cfg.rope_theta)


def _embed_in(params, cfg: ModelConfig, batch):
    """The input activations [B, S, D] and their positions.  Embeddings
    input (``input_mode="embeds"``): ``batch["embeds"]`` cast to the
    model's dtype, unscaled, and ``batch["positions"]`` as given ([B, S],
    or [B, S, 3] under M-RoPE).  Tokens: their embeddings (scaled) and
    positions [B, S].  The gather is ``index_select``, whose backward on a
    card is deterministic under ``torch.use_deterministic_algorithms``
    (advanced indexing accumulates repeated tokens' rows with atomics)."""
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(getattr(torch, cfg.dtype))
        return x, batch["positions"]
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = torch.index_select(params["embed"], 0, tokens.reshape(-1).long())
    x = _embed_scale(cfg, x.reshape(B, S, -1))
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    return x, positions


def _layer_spans(cfg: ModelConfig) -> list[tuple[int, int]]:
    """[lo, hi) layer ranges checkpointed together: groups of
    ``remat_group`` layers, then the non-dividing tail one layer each."""
    G, L = max(1, cfg.remat_group), cfg.num_layers
    if G > 1 and L >= G:
        n = L // G * G
        return ([(i, i + G) for i in range(0, n, G)]
                + [(i, i + 1) for i in range(n, L)])
    return [(i, i + 1) for i in range(L)]


def forward_hidden(params, cfg: ModelConfig, x, sin, cos, *, q_offset=0):
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
                                  window=windows[i], q_offset=q_offset)
                x, a = _ffn(cfg, x, layers[i])
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
    x, positions = _embed_in(params, cfg, batch)
    sin, cos = _angles(cfg, positions)
    hidden, aux = forward_hidden(params, cfg, x, sin, cos)
    total, count = chunked_softmax_xent(
        hidden, _unembed(params), batch["targets"], batch["mask"],
        chunk=cfg.vocab_chunk or min(512, hidden.shape[1]),
        softcap=cfg.logit_softcap)
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
    x, positions = _embed_in(params, cfg, batch)
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
        x, (k, v) = _attention(cfg, x, lp, sin, cos, window=window)
        x, _ = _ffn(cfg, x, lp)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    cache = {"k": ks, "v": vs,
             "length": torch.tensor(S, dtype=torch.int32, device=dev)}
    return _logits(params, cfg, x), cache


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
    ``decode_attention``)."""
    if cfg.input_mode == "embeds" and "embeds" in batch:
        x, positions = _embed_in(params, cfg, batch)
    else:
        x = _embed_scale(cfg, params["embed"][batch["token"].long()])
        positions = batch["pos"][:, None]
    if cfg.mrope and positions.dim() == 2:
        positions = torch.stack([positions] * 3, dim=-1)
    sin, cos = _angles(cfg, positions)
    length = cache["length"]
    B = x.shape[0]
    layers = _layer_params(params, cfg)
    for i, window in enumerate(_layer_windows(cfg)):
        lp = layers[i]
        q, k, v = _qkv(cfg, x, lp, sin, cos)
        kc, vc = cache["k"][i], cache["v"][i]          # views: [B, Smax, KV, hd]
        write_token(kc, k, length, entry="k")
        write_token(vc, v, length, entry="v")
        out = decode_attention(q, kc, vc, length + 1, window=window,
                               softcap=cfg.attn_softcap, entry="k")
        x = x + out.reshape(B, 1, -1) @ lp["wo"]
        x, _ = _ffn(cfg, x, lp)
    new_cache = {"k": cache["k"], "v": cache["v"], "length": length + 1}
    return _logits(params, cfg, x), new_cache


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
    )
