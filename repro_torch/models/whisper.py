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

Where the sharded train, prefill or decode step splits the compute over
the model axis, every attention (the encoder's, the decoder's and the
cross-attention) and every MLP split as the transformer family's do
(``models/transformer.py::_Split``: heads and kv heads where the axis
divides them, the MLP's hidden, ``wo`` and ``xo`` row-split with their
partial sums reduced at the residual's hint); the cross K/V are computed
on this process's kv heads, and the vocab stays whole (the rule table
replicates it).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.context import (mesh_context, shard_hint, split_of,
                                         use_mesh_context)
from repro_torch.distrib.tensor_parallel import (copy_to_group,
                                                 gather_from_group,
                                                 split_to_group)
from repro_torch.models import transformer as T
from repro_torch.models.api import (
    BatchSpec,
    ParamSpec,
    TorchModelApi,
    token_batch_specs,
)
from repro_torch.models.layers import (
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


# ------------------------------------------------------ tensor parallelism
_FFN_KEYS = ("w_gate", "w_up", "w_down")


def split_params(cfg: ModelConfig) -> set[str]:
    """The parameters the loss, the prefill and the decode step take as
    this process's part of their model split under the installed context
    (the transformer's ``_Split``: the cross-attention's ``xq``, ``xk``,
    ``xv`` and ``xo`` as ``wq``, ``wk``, ``wv`` and ``wo``); they take
    every other parameter whole."""
    s = T._split(cfg)
    keys = (["wq", "xq"] if s.q else []) + (
        ["wk", "wv", "xk", "xv"] if s.kv else []) + (
        ["wo", "xo"] if s.out else [])
    names = {f"dec/{k}" for k in keys}
    for pre in ("enc", "dec"):
        names |= {f"{pre}/{k}" for k in keys if not k.startswith("x")}
        names |= {f"{pre}/{k}" for k in _FFN_KEYS} if s.mlp else set()
    return names | ({"embed"} if s.vocab else set())


# -------------------------------------------------------------- forward
def _attend(cfg: ModelConfig, q, k, v, *, causal: bool):
    """The family's one attention path: blocked, no window, no softcap."""
    return flash_attention_xla(q, k, v, causal=causal,
                               block_q=cfg.attn_block_q,
                               block_k=cfg.attn_block_k)


def _sa(cfg: ModelConfig, x, lp, sin, cos, *, causal: bool,
        s: T._Split = T.NO_SPLIT):
    """x + self-attention of x, and the layer's (k, v) [B, S, KV, hd]
    (this process's kv heads where they are split): the transformer's q,
    k, v, heads and output by their hints."""
    B, S, D = x.shape
    q, k, v = T._qkv(cfg, x, lp, sin, cos, s=s)
    out = _attend(cfg, *T._attention_heads(cfg, s, q, k, v), causal=causal)
    out = T._attention_out(cfg, s, out)
    return x + shard_hint(out @ lp["wo"], ("batch", None, None), (B, S, D),
                          partial=s.out), (k, v)


def _mlp(cfg: ModelConfig, x, lp, s: T._Split = T.NO_SPLIT):
    return T._ffn(cfg, x, lp, s=s)[0]


def _cross_kv(cfg: ModelConfig, enc_states, lp, s: T._Split = T.NO_SPLIT):
    """The layer's cross K/V [B, Se, KV, hd] from the encoder states (held
    whole), on this process's kv heads where ``xk``, ``xv`` are split."""
    B, Se, _ = enc_states.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim_
    es = copy_to_group(enc_states, s.group) if s.kv else enc_states
    return tuple(shard_hint((es @ lp[w]).reshape(B, Se, -1, hd),
                            ("batch", None, "kv_heads", None),
                            (B, Se, KV, hd)) for w in ("xk", "xv"))


def _cross_q(cfg: ModelConfig, x, lp, s: T._Split = T.NO_SPLIT):
    """The cross-attention's q [B, S, Hq, hd] (this process's heads where
    ``xq`` is split)."""
    B, S, _ = x.shape
    Hq, hd = cfg.num_heads, cfg.head_dim_
    h = rms_norm(x, lp["ln_x"])
    if s.q:
        h = copy_to_group(h, s.group)
    return shard_hint((h @ lp["xq"]).reshape(B, S, -1, hd),
                      ("batch", None, "heads", None), (B, S, Hq, hd))


def _cross(cfg: ModelConfig, x, lp, enc_k, enc_v, s: T._Split = T.NO_SPLIT):
    """Cross-attention; enc_k / enc_v [B, Se, KV, hd] precomputed."""
    B, S, D = x.shape
    q = _cross_q(cfg, x, lp, s)
    out = _attend(cfg, *T._attention_heads(cfg, s, q, enc_k, enc_v),
                  causal=False)
    out = T._attention_out(cfg, s, out)
    return x + shard_hint(out @ lp["xo"], ("batch", None, None), (B, S, D),
                          partial=s.out)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _layers(cfg: ModelConfig, body, x, layers):
    """``x = body(x, lp)`` over ``layers``, each layer checkpointed under
    autograd when ``cfg.remat`` (the reference's ``jax.checkpoint`` of its
    scan body).  A checkpointed layer is recomputed on the autograd
    engine's thread (a card's own), which does not see this thread's
    context: each installs the one its forward ran under."""
    remat = cfg.remat and torch.is_grad_enabled()
    ctx = mesh_context()

    def run(x, lp):
        with use_mesh_context(ctx):
            return body(x, lp)

    for lp in layers:
        x = (checkpoint(run, x, lp, use_reentrant=False) if remat
             else body(x, lp))
    return x


def encode(params, cfg: ModelConfig, frames, s: T._Split = T.NO_SPLIT):
    """frames [B, Se, D] (the stub conv output) -> encoder states [B, Se, D]."""
    B, Se, _ = frames.shape
    sin, cos = rope_angles(_positions(B, Se, frames.device), cfg.head_dim_,
                           cfg.rope_theta)

    def body(x, lp):
        x, _ = _sa(cfg, x, lp, sin, cos, causal=False, s=s)
        return _mlp(cfg, x, lp, s)

    x = _layers(cfg, body, frames.to(getattr(torch, cfg.dtype)),
                unstack_layers(params, "enc"))
    return rms_norm(x, params["enc_norm"])


def _decoder_hidden(params, cfg: ModelConfig, tokens, enc_states, *,
                    keep_cache: bool = False, s: T._Split = T.NO_SPLIT):
    """Every decoder layer over ``tokens`` [B, S] against ``enc_states``;
    returns (final-normed hidden [B, S, D], the layers' (k, v, xk, xv)
    stacked [Ld, B, ., KV, hd] when ``keep_cache``, else None): k and v
    with every kv head, the cross K/V on this process's kv heads where
    they are split.  The tokens' rows of the table are looked up unscaled
    (``index_select``, whose backward on a card is deterministic under
    ``torch.use_deterministic_algorithms``)."""
    B, S = tokens.shape
    KV = cfg.num_kv_heads
    sin, cos = rope_angles(_positions(B, S, tokens.device), cfg.head_dim_,
                           cfg.rope_theta)
    caches = []

    def body(x, lp):
        x, (k, v) = _sa(cfg, x, lp, sin, cos, causal=True, s=s)
        ek, ev = _cross_kv(cfg, enc_states, lp, s)
        if keep_cache:
            caches.append((T._whole(k, s.group, 2, KV),
                           T._whole(v, s.group, 2, KV), ek, ev))
        x = _cross(cfg, x, lp, ek, ev, s)
        return _mlp(cfg, x, lp, s)

    x = _layers(cfg, body, T._lookup(params, cfg, tokens, s=s),
                unstack_layers(params, "dec"))
    stacked = (tuple(torch.stack(c) for c in zip(*caches)) if keep_cache
               else None)
    return rms_norm(x, params["final_norm"]), stacked


def loss_fn(params, cfg: ModelConfig, batch):
    s = T._split(cfg)
    enc = encode(params, cfg, batch["enc_frames"], s)
    hidden, _ = _decoder_hidden(params, cfg, batch["tokens"], enc, s=s)
    total, count = chunked_softmax_xent(
        copy_to_group(hidden, s.group) if s.vocab else hidden,
        params["embed"].to(torch.bfloat16).t(), batch["targets"],
        batch["mask"], chunk=cfg.vocab_chunk or min(512, hidden.shape[1]),
        vocab=split_of(cfg.vocab) if s.vocab else None)
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


def _logits(params, hidden, s: T._Split = T.NO_SPLIT):
    """The last position's f32 logits against the f32 table [B, V]."""
    logits = hidden[:, -1].float() @ params["embed"].float().t()
    return gather_from_group(logits, s.group, 1) if s.vocab else logits


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """Encode ``batch["enc_frames"]``, run the decoder over
    ``batch["tokens"]`` [B, S] (a zero BOS column [B, 1] when the batch has
    none); returns (last-token logits [B, V] f32, the cache: self-attention
    k/v zero-padded to ``Smax``, the cross K/V at Se, a 0-d length S).
    Under the model axis the cross K/V are this process's kv heads."""
    s = T._split(cfg)
    enc = encode(params, cfg, batch["enc_frames"], s)
    tokens = batch.get("tokens")
    if tokens is None:
        tokens = torch.zeros((enc.shape[0], 1), dtype=torch.int32,
                             device=enc.device)          # BOS priming
    B, S = tokens.shape
    Smax = Smax or S
    hidden, (ks, vs, xks, xvs) = _decoder_hidden(params, cfg, tokens, enc,
                                                 keep_cache=True, s=s)
    pad = (0, 0, 0, 0, 0, Smax - S)
    cache = {"k": F.pad(ks, pad), "v": F.pad(vs, pad), "xk": xks, "xv": xvs,
             "length": torch.tensor(S, dtype=torch.int32, device=enc.device)}
    return _logits(params, hidden, s), cache


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token in (``token`` [B, 1], ``pos`` [B]), one token's logits
    out.  The new k/v are written into ``cache["k"]`` / ``cache["v"]`` at
    ``cache["length"]`` (0-d) IN PLACE; the cross-attention reads the fixed
    ``xk`` / ``xv`` over all Se frames.  Returns (logits, a dict sharing
    the cache's tensors with ``length + 1``).  Under the sharded decode
    step the cache is this process's shard: k/v split on ``kv_seq``, the
    cross K/V on ``kv_heads``.

    Where the step splits the compute over the model axis (as the prefill
    does), q, k and v are computed on this process's heads and the one
    token's are gathered to meet the key range it holds (the
    sequence-parallel ``decode_attention``); the cross-attention's q on
    its heads attends its kv heads of the cross K/V, and that output
    feeds ``xo``'s rows as it is; each row-split product is reduced at
    the residual's hint and the MLP runs column-split."""
    s = T._split(cfg)
    token = batch["token"]
    B, D = token.shape[0], cfg.d_model
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    x = T._lookup(params, cfg, token, s=s)
    sin, cos = rope_angles(batch["pos"][:, None], cfg.head_dim_,
                           cfg.rope_theta)
    length = cache["length"]
    frames = torch.full((), cache["xk"].shape[2], dtype=torch.int32,
                        device=x.device)
    for i, lp in enumerate(unstack_layers(params, "dec")):
        q, k1, v1 = T._qkv(cfg, x, lp, sin, cos, s=s)
        q, k1, v1 = (T._whole(q, s.group, 2, Hq), T._whole(k1, s.group, 2, KV),
                     T._whole(v1, s.group, 2, KV))
        kc, vc = cache["k"][i], cache["v"][i]          # views: [B, Smax, KV, hd]
        write_token(kc, k1, length, entry="k")
        write_token(vc, v1, length, entry="v")
        out = decode_attention(q, kc, vc, length + 1,
                               entry="k").reshape(B, 1, -1)
        if s.out:
            out = split_to_group(out, s.group, 2)
        x = x + shard_hint(out @ lp["wo"], ("batch", None, None), (B, 1, D),
                           partial=s.out)
        # cross attention against the fixed encoder K/V
        ek, ev = cache["xk"][i], cache["xv"][i]
        # this process's heads against its kv heads of the cache where
        # the axis splits them (the cache's split is the heads'), else
        # every head
        qx = _cross_q(cfg, x, lp, s)
        if s.attn != "kv":
            qx = T._whole(qx, s.group, 2, Hq)
        outx = decode_attention(qx, ek, ev, frames).reshape(B, 1, -1)
        if s.out and s.attn != "kv":
            outx = split_to_group(outx, s.group, 2)
        x = x + shard_hint(outx @ lp["xo"], ("batch", None, None), (B, 1, D),
                           partial=s.out)
        x = _mlp(cfg, x, lp, s)
    hidden = rms_norm(x, params["final_norm"])
    new_cache = {"k": cache["k"], "v": cache["v"], "xk": cache["xk"],
                 "xv": cache["xv"], "length": length + 1}
    return _logits(params, hidden, s), new_cache


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
