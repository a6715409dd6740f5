"""Whisper-style encoder-decoder (audio backbone; the conv frontend is a
stub: ``enc_frames`` are precomputed frame embeddings) — the counterpart of
the JAX package's ``models/whisper.py`` (whisper-base).

Encoder: bidirectional self-attention over the frames, RoPE at positions
0..Se-1 (the reference's recorded adaptation of Whisper's learned
positions).  Decoder: causal self-attention, cross-attention over the
encoder states, SwiGLU MLP.  Every attention of the family, the encoder's,
the decoder's and the cross-attention, takes the blocked plain path
(``flash_attention_xla``), as in the reference, whatever
``attention_impl`` says.  Serving: the cross K/V are computed once at
prefill, kept unpadded at Se in the cache, and read by every decode step.

Parameters keep the reference's stacked ``enc/*`` and ``dec/*`` layouts;
where the reference scans over layers this runs a Python loop over the
per-layer slices, and ``cfg.remat`` checkpoints each encoder and each
decoder layer (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scan body does.  A decode step writes the new
token's self-attention k/v into ``cache["k"]`` and ``cache["v"]`` in place,
as the port's decoder-only family does; the cross K/V are never written.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
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
    rms_norm,
    rope_angles,
    unstack_layers,
    write_token,
)


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, Hq, KV, hd, Fd, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim_, cfg.d_ff, cfg.vocab)
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    dt = cfg.dtype
    p = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), dt),
        "final_norm": ParamSpec((D,), ("embed",), dt, init="zeros"),
        "enc_norm": ParamSpec((D,), ("embed",), dt, init="zeros"),
    }
    for pre, L in (("enc", Le), ("dec", Ld)):
        p[f"{pre}/ln1"] = ParamSpec((L, D), ("layers", "embed"), dt, init="zeros")
        p[f"{pre}/ln2"] = ParamSpec((L, D), ("layers", "embed"), dt, init="zeros")
        p[f"{pre}/wq"] = ParamSpec((L, D, Hq * hd), ("layers", "embed", "heads"), dt)
        p[f"{pre}/wk"] = ParamSpec((L, D, KV * hd), ("layers", "embed", "kv_heads"), dt)
        p[f"{pre}/wv"] = ParamSpec((L, D, KV * hd), ("layers", "embed", "kv_heads"), dt)
        p[f"{pre}/wo"] = ParamSpec((L, Hq * hd, D), ("layers", "heads", "embed"), dt)
        p[f"{pre}/w_gate"] = ParamSpec((L, D, Fd), ("layers", "embed", "mlp"), dt)
        p[f"{pre}/w_up"] = ParamSpec((L, D, Fd), ("layers", "embed", "mlp"), dt)
        p[f"{pre}/w_down"] = ParamSpec((L, Fd, D), ("layers", "mlp", "embed"), dt)
    # decoder cross-attention
    p["dec/ln_x"] = ParamSpec((Ld, D), ("layers", "embed"), dt, init="zeros")
    p["dec/xq"] = ParamSpec((Ld, D, Hq * hd), ("layers", "embed", "heads"), dt)
    p["dec/xk"] = ParamSpec((Ld, D, KV * hd), ("layers", "embed", "kv_heads"), dt)
    p["dec/xv"] = ParamSpec((Ld, D, KV * hd), ("layers", "embed", "kv_heads"), dt)
    p["dec/xo"] = ParamSpec((Ld, Hq * hd, D), ("layers", "heads", "embed"), dt)
    return p


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool):
    """The family's one attention path: blocked, no window, no softcap."""
    return flash_attention_xla(q, k, v, causal=causal,
                               block_q=cfg.attn_block_q,
                               block_k=cfg.attn_block_k)


def _sa(cfg: ModelConfig, x, lp, sin, cos, *, causal: bool):
    """x + self-attention of x, and the layer's (k, v) [B, S, KV, hd]."""
    B, S, _ = x.shape
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = rms_norm(x, lp["ln1"])
    q = apply_rope((h @ lp["wq"]).reshape(B, S, Hq, hd), sin, cos)
    k = apply_rope((h @ lp["wk"]).reshape(B, S, KV, hd), sin, cos)
    v = (h @ lp["wv"]).reshape(B, S, KV, hd)
    out = _attend(cfg, q, k, v, causal=causal)
    return x + out.reshape(B, S, Hq * hd) @ lp["wo"], (k, v)


def _mlp(x, lp):
    h = rms_norm(x, lp["ln2"])
    y = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + y @ lp["w_down"]


def _cross(cfg: ModelConfig, x, lp, enc_k, enc_v):
    """Cross-attention; enc_k / enc_v [B, Se, KV, hd] precomputed."""
    B, S, _ = x.shape
    Hq, hd = cfg.num_heads, cfg.head_dim_
    h = rms_norm(x, lp["ln_x"])
    q = (h @ lp["xq"]).reshape(B, S, Hq, hd)
    out = _attend(cfg, q, enc_k, enc_v, causal=False)
    return x + out.reshape(B, S, Hq * hd) @ lp["xo"]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _layers(cfg: ModelConfig, body, x, layers):
    """``x = body(x, lp)`` over ``layers``, each layer checkpointed under
    autograd when ``cfg.remat`` (the reference's ``jax.checkpoint`` of its
    scan body)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        x = (checkpoint(body, x, lp, use_reentrant=False) if remat
             else body(x, lp))
    return x


def encode(params, cfg: ModelConfig, frames):
    """frames [B, Se, D] (the stub conv output) -> encoder states [B, Se, D]."""
    B, Se, _ = frames.shape
    sin, cos = rope_angles(_positions(B, Se, frames.device), cfg.head_dim_,
                           cfg.rope_theta)

    def body(x, lp):
        x, _ = _sa(cfg, x, lp, sin, cos, causal=False)
        return _mlp(x, lp)

    x = _layers(cfg, body, frames.to(getattr(torch, cfg.dtype)),
                unstack_layers(params, "enc"))
    return rms_norm(x, params["enc_norm"])


def _embed(params, tokens):
    """The tokens' rows of the table, unscaled.  ``index_select``, whose
    backward on a card is deterministic under
    ``torch.use_deterministic_algorithms``."""
    x = torch.index_select(params["embed"], 0, tokens.reshape(-1).long())
    return x.reshape(*tokens.shape, -1)


def _decoder_hidden(params, cfg: ModelConfig, tokens, enc_states, *,
                    keep_cache: bool = False):
    """Every decoder layer over ``tokens`` [B, S] against ``enc_states``;
    returns (final-normed hidden [B, S, D], the layers' (k, v, xk, xv)
    stacked [Ld, B, ., KV, hd] when ``keep_cache``, else None)."""
    B, S = tokens.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    sin, cos = rope_angles(_positions(B, S, tokens.device), cfg.head_dim_,
                           cfg.rope_theta)
    caches = []

    def body(x, lp):
        x, (k, v) = _sa(cfg, x, lp, sin, cos, causal=True)
        ek = (enc_states @ lp["xk"]).reshape(B, -1, KV, hd)
        ev = (enc_states @ lp["xv"]).reshape(B, -1, KV, hd)
        if keep_cache:
            caches.append((k, v, ek, ev))
        x = _cross(cfg, x, lp, ek, ev)
        return _mlp(x, lp)

    x = _layers(cfg, body, _embed(params, tokens),
                unstack_layers(params, "dec"))
    stacked = (tuple(torch.stack(c) for c in zip(*caches)) if keep_cache
               else None)
    return rms_norm(x, params["final_norm"]), stacked


def loss_fn(params, cfg: ModelConfig, batch):
    enc = encode(params, cfg, batch["enc_frames"])
    hidden, _ = _decoder_hidden(params, cfg, batch["tokens"], enc)
    total, count = chunked_softmax_xent(
        hidden, params["embed"].to(torch.bfloat16).t(), batch["targets"],
        batch["mask"], chunk=cfg.vocab_chunk or min(512, hidden.shape[1]))
    return total / torch.clamp(count, min=1.0), {}


# ----------------------------------------------------------------- serving
def cache_specs(cfg: ModelConfig, B: int, Smax: int) -> dict[str, BatchSpec]:
    KV, hd, Ld = cfg.num_kv_heads, cfg.head_dim_, cfg.num_layers
    Se = cfg.encoder_seq
    return {
        "k": BatchSpec((Ld, B, Smax, KV, hd), cfg.dtype),
        "v": BatchSpec((Ld, B, Smax, KV, hd), cfg.dtype),
        "xk": BatchSpec((Ld, B, Se, KV, hd), cfg.dtype),   # computed once
        "xv": BatchSpec((Ld, B, Se, KV, hd), cfg.dtype),
        "length": BatchSpec((), "int32"),
    }


def cache_axes(cfg: ModelConfig):
    """Self-attention k/v on ``kv_seq``; the cross K/V on ``kv_heads``."""
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None),
            "xk": ("layers", "batch", None, "kv_heads", None),
            "xv": ("layers", "batch", None, "kv_heads", None),
            "length": ()}


def _logits(params, hidden):
    """The last position's f32 logits against the f32 table [B, V]."""
    return hidden[:, -1].float() @ params["embed"].float().t()


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """Encode ``batch["enc_frames"]``, run the decoder over
    ``batch["tokens"]`` [B, S] (a zero BOS column [B, 1] when the batch has
    none); returns (last-token logits [B, V] f32, the cache: self-attention
    k/v zero-padded to ``Smax``, the cross K/V at Se, a 0-d length S)."""
    enc = encode(params, cfg, batch["enc_frames"])
    tokens = batch.get("tokens")
    if tokens is None:
        tokens = torch.zeros((enc.shape[0], 1), dtype=torch.int32,
                             device=enc.device)          # BOS priming
    B, S = tokens.shape
    Smax = Smax or S
    hidden, (ks, vs, xks, xvs) = _decoder_hidden(params, cfg, tokens, enc,
                                                 keep_cache=True)
    pad = (0, 0, 0, 0, 0, Smax - S)
    cache = {"k": F.pad(ks, pad), "v": F.pad(vs, pad), "xk": xks, "xv": xvs,
             "length": torch.tensor(S, dtype=torch.int32, device=enc.device)}
    return _logits(params, hidden), cache


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token in (``token`` [B, 1], ``pos`` [B]), one token's logits
    out.  The new k/v are written into ``cache["k"]`` / ``cache["v"]`` at
    ``cache["length"]`` (0-d) IN PLACE; the cross-attention reads the fixed
    ``xk`` / ``xv`` over all Se frames.  Returns (logits, a dict sharing
    the cache's tensors with ``length + 1``).  Under the sharded decode
    step the cache is this process's shard: k/v split on ``kv_seq``, the
    cross K/V on ``kv_heads`` (``decode_attention`` attends with this
    process's heads and gathers the heads' outputs)."""
    token = batch["token"]
    B = token.shape[0]
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    x = _embed(params, token)
    sin, cos = rope_angles(batch["pos"][:, None], cfg.head_dim_,
                           cfg.rope_theta)
    length = cache["length"]
    frames = torch.full((), cache["xk"].shape[2], dtype=torch.int32,
                        device=x.device)
    for i, lp in enumerate(unstack_layers(params, "dec")):
        h = rms_norm(x, lp["ln1"])
        q = apply_rope((h @ lp["wq"]).reshape(B, 1, Hq, hd), sin, cos)
        k1 = apply_rope((h @ lp["wk"]).reshape(B, 1, KV, hd), sin, cos)
        v1 = (h @ lp["wv"]).reshape(B, 1, KV, hd)
        kc, vc = cache["k"][i], cache["v"][i]          # views: [B, Smax, KV, hd]
        write_token(kc, k1, length, entry="k")
        write_token(vc, v1, length, entry="v")
        out = decode_attention(q, kc, vc, length + 1, entry="k")
        x = x + out.reshape(B, 1, Hq * hd) @ lp["wo"]
        # cross attention against the fixed encoder K/V
        ek, ev = cache["xk"][i], cache["xv"][i]
        hx = rms_norm(x, lp["ln_x"])
        qx = (hx @ lp["xq"]).reshape(B, 1, Hq, hd)
        outx = decode_attention(qx, ek, ev, frames, entry="xk")
        x = x + outx.reshape(B, 1, Hq * hd) @ lp["xo"]
        x = _mlp(x, lp)
    hidden = rms_norm(x, params["final_norm"])
    new_cache = {"k": cache["k"], "v": cache["v"], "xk": cache["xk"],
                 "xv": cache["xv"], "length": length + 1}
    return _logits(params, hidden), new_cache


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
