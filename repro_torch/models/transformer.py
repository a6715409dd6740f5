"""Decoder-only LM family (dense path): GQA, qk-norm, softcaps,
local/global alternation, RoPE, tied embeddings — the counterpart of the
JAX package's ``models/transformer.py`` for the dense family.

Parameters keep the reference's stacked ``[L, ...]`` layout; where the
reference scans over layers, this runs a Python loop over the per-layer
slices.  MoE FFNs, M-RoPE, embeddings input and the training loss are not
ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.api import BatchSpec, ParamSpec, TorchModelApi
from repro_torch.models.layers import (
    apply_rope,
    decode_attention,
    flash_attention_xla,
    naive_attention,
    rms_norm,
    rope_angles,
)

F32 = torch.float32

_LAYER_KEYS = ["ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
               "w_down"]


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
        "w_gate": ParamSpec((L, D, Fd), ("layers", "embed", "mlp"), dt),
        "w_up": ParamSpec((L, D, Fd), ("layers", "embed", "mlp"), dt),
        "w_down": ParamSpec((L, Fd, D), ("layers", "mlp", "embed"), dt),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((V, D), ("vocab", "embed"), dt)
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((L, hd), ("layers", None), dt, init="zeros")
        p["k_norm"] = ParamSpec((L, hd), ("layers", None), dt, init="zeros")
    return p


def _layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding-window size (0 = full attention)."""
    return [cfg.local_window if k == "local" else 0 for k in cfg.layer_kinds()]


def _layer_params(params, cfg: ModelConfig, i: int) -> dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked per-layer parameters."""
    keys = _LAYER_KEYS + (["q_norm", "k_norm"] if cfg.qk_norm else [])
    return {k: params[k][i] for k in keys}


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
        # the hand-written kernel (its plain version on CPU tensors); as in
        # the reference it takes one static window, so it engages for
        # uniform-window patterns only
        out = flash_attention(q, k, v, causal=True, window=0,
                              softcap=cfg.attn_softcap, q_offset=int(q_offset))
    else:
        out = flash_attention_xla(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap,
                                  block_q=cfg.attn_block_q,
                                  block_k=cfg.attn_block_k,
                                  q_offset=q_offset)
    return x + out.reshape(B, S, -1) @ lp["wo"], (k, v)


def _ffn(cfg: ModelConfig, x, lp):
    h = rms_norm(x, lp["ln2"])
    y = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + y @ lp["w_down"]


def _embed_scale(cfg: ModelConfig, x):
    # sqrt(d_model) rounded to x's dtype first, as the reference does
    return x * torch.tensor(math.sqrt(cfg.d_model), dtype=F32).to(x.dtype)


def _logits(params, cfg: ModelConfig, x):
    hidden = rms_norm(x, params["final_norm"])
    w = params.get("unembed", params["embed"])
    # the reference unembeds through a bf16 copy of the table, whatever
    # the parameter dtype
    logits = hidden[:, -1].float() @ w.to(torch.bfloat16).float().t()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------- serving
def cache_specs(cfg: ModelConfig, B: int, Smax: int) -> dict[str, BatchSpec]:
    KV, hd, L = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    return {
        "k": BatchSpec((L, B, Smax, KV, hd), cfg.dtype),
        "v": BatchSpec((L, B, Smax, KV, hd), cfg.dtype),
        "length": BatchSpec((), "int32"),
    }


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """Full-sequence forward; returns (last-token logits [B, V] f32, filled
    cache).  ``batch["tokens"]`` is [B, S] on the parameters' device."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    Smax = Smax or S
    dev = params["embed"].device
    dtype = getattr(torch, cfg.dtype)
    x = _embed_scale(cfg, params["embed"][tokens.long()])
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    sin, cos = rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    shape = (cfg.num_layers, B, Smax, cfg.num_kv_heads, cfg.head_dim_)
    ks = torch.zeros(shape, dtype=dtype, device=dev)
    vs = torch.zeros(shape, dtype=dtype, device=dev)
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer_params(params, cfg, i)
        x, (k, v) = _attention(cfg, x, lp, sin, cos, window=window)
        x = _ffn(cfg, x, lp)
        ks[i, :, :S] = k
        vs[i, :, :S] = v
    cache = {"k": ks, "v": vs,
             "length": torch.tensor(S, dtype=torch.int32, device=dev)}
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token in, one token's logits out.

    batch: token [B, 1], pos [B] (tensors on the parameters' device).
    ``cache["length"]`` is a 0-d tensor (all sequences in step) or a
    PER-SLOT [B] vector (the continuous-batching engine: each slot writes
    its own cache position).  Unlike the reference, which returns a new
    cache, the new token's k/v are written into ``cache["k"]`` and
    ``cache["v"]`` IN PLACE; the returned dict shares those tensors and
    carries ``length + 1``."""
    x = _embed_scale(cfg, params["embed"][batch["token"].long()])
    positions = batch["pos"][:, None]
    sin, cos = rope_angles(positions, cfg.head_dim_, cfg.rope_theta)
    length = cache["length"]
    B = x.shape[0]
    rows = torch.arange(B, device=x.device)
    for i, window in enumerate(_layer_windows(cfg)):
        lp = _layer_params(params, cfg, i)
        q, k, v = _qkv(cfg, x, lp, sin, cos)
        kc, vc = cache["k"][i], cache["v"][i]          # views: [B, Smax, KV, hd]
        if length.dim() == 0:
            kc.index_copy_(1, length.reshape(1).long(), k)
            vc.index_copy_(1, length.reshape(1).long(), v)
        else:                                          # per-slot lengths [B]
            kc[rows, length.long()] = k[:, 0]
            vc[rows, length.long()] = v[:, 0]
        out = decode_attention(q, kc, vc, length + 1, window=window,
                               softcap=cfg.attn_softcap)
        x = x + out.reshape(B, 1, -1) @ lp["wo"]
        x = _ffn(cfg, x, lp)
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
    )
