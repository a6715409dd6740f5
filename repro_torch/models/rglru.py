"""RecurrentGemma / Griffin family: RG-LRU recurrent blocks and local
attention, pattern (recurrent, recurrent, local-attn) repeating — the
counterpart of the JAX package's ``models/rglru.py``.

RG-LRU recurrence (Griffin eq. 1-4):
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
The gates are PyTorch; the recurrence over a prompt or a training sequence
goes through the hand-written ``rglru_scan`` kernel (its plain version on
CPU tensors) under autograd (``lru_scan_vjp``, whose backward is the same
kernel run backwards in time), and a decode step is one multiply-add in
PyTorch, as in the reference.  Attention layers use a sliding window, so
their decode caches are window-sized ring buffers.

Parameters keep the reference's stacked ``[n, ...]`` layout (one stack for
the recurrent layers, one for the attention layers) and its precision
choices.  Training checkpoints each (lru, lru, local) group under
``cfg.remat``, as the reference's ``jax.checkpoint`` over its scanned
groups; the recurrent layers past the last whole group run unchecked.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.context import mesh_context, use_mesh_context
from repro_torch.kernels.rglru_scan.ops import lru_scan_vjp
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
    softplus,
    unstack_layers,
)
from repro_torch.models.transformer import _embed_scale

F32 = torch.float32
C_CONST = 8.0


# ------------------------------------------------------------- param specs
def _counts(cfg: ModelConfig) -> tuple[int, int]:
    kinds = cfg.layer_kinds()
    return sum(k == "lru" for k in kinds), sum(k == "local" for k in kinds)


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, Hq, KV, hd, Fd, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim_, cfg.d_ff, cfg.vocab)
    W = cfg.lru_width or D
    cw = cfg.conv_width
    n_lru, n_attn = _counts(cfg)
    dt = cfg.dtype
    p = {
        "embed": ParamSpec((V, D), ("vocab", "embed"), dt),
        "final_norm": ParamSpec((D,), ("embed",), dt, init="zeros"),
    }
    for pre, n in (("lru", n_lru), ("attn", n_attn)):
        p[f"{pre}/ln1"] = ParamSpec((n, D), ("layers", "embed"), dt, init="zeros")
        p[f"{pre}/ln2"] = ParamSpec((n, D), ("layers", "embed"), dt, init="zeros")
        p[f"{pre}/w_gate"] = ParamSpec((n, D, Fd), ("layers", "embed", "mlp"), dt)
        p[f"{pre}/w_up"] = ParamSpec((n, D, Fd), ("layers", "embed", "mlp"), dt)
        p[f"{pre}/w_down"] = ParamSpec((n, Fd, D), ("layers", "mlp", "embed"), dt)
    # recurrent mixer
    p["lru/w_y"] = ParamSpec((n_lru, D, W), ("layers", "embed", "mlp"), dt)
    p["lru/w_x"] = ParamSpec((n_lru, D, W), ("layers", "embed", "mlp"), dt)
    p["lru/conv"] = ParamSpec((n_lru, cw, W), ("layers", None, "mlp"), dt)
    p["lru/w_a"] = ParamSpec((n_lru, W, W), ("layers", "mlp", None), dt)
    p["lru/w_i"] = ParamSpec((n_lru, W, W), ("layers", "mlp", None), dt)
    p["lru/lam"] = ParamSpec((n_lru, W), ("layers", "mlp"), dt, init="ones")
    p["lru/w_out"] = ParamSpec((n_lru, W, D), ("layers", "mlp", "embed"), dt)
    # local attention mixer
    p["attn/wq"] = ParamSpec((n_attn, D, Hq * hd), ("layers", "embed", "heads"), dt)
    p["attn/wk"] = ParamSpec((n_attn, D, KV * hd), ("layers", "embed", "kv_heads"), dt)
    p["attn/wv"] = ParamSpec((n_attn, D, KV * hd), ("layers", "embed", "kv_heads"), dt)
    p["attn/wo"] = ParamSpec((n_attn, Hq * hd, D), ("layers", "heads", "embed"), dt)
    return p


def _stack_slice(params, prefix: str, i: int) -> dict[str, torch.Tensor]:
    """Layer ``i`` of the ``prefix/`` stack, keyed without the prefix."""
    return {k.split("/", 1)[1]: v[i] for k, v in params.items()
            if k.startswith(prefix + "/")}


# ------------------------------------------------------------ lru pieces
def _causal_conv(x, kernel, state=None):
    """Depthwise causal conv along time.  x [B,S,W]; kernel [cw, W];
    state [B, cw-1, W] (decode carry) or None (zeros).  The shifted
    products are summed in x's dtype, in the reference's order, from 0."""
    cw = kernel.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * kernel[i][None, None]
              for i in range(cw))
    new_state = xp[:, -(cw - 1):] if cw > 1 else state
    return out, new_state


def _lru_gates(x, lp):
    # f32 products, as the reference's x.astype(F32) @ w.astype(F32); they
    # stay full f32 on the card while torch.backends.cuda.matmul.allow_tf32
    # keeps its default (False)
    xf = x.float()
    r = torch.sigmoid(xf @ lp["w_a"].float())
    i = torch.sigmoid(xf @ lp["w_i"].float())
    log_a = -C_CONST * softplus(lp["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return a, b


def _lru_scan(x, lp, h0=None):
    """x [B,S,W] -> (y [B,S,W] in x's dtype, h_last [B,W] f32), through the
    ``rglru_scan`` kernel (under autograd)."""
    a, b = _lru_gates(x, lp)
    h, h_last = lru_scan_vjp(a, b, None if h0 is None else h0.float())
    return h.to(x.dtype), h_last


def _lru_step(x1, lp, h):
    """Single decode step: x1 [B,1,W], h [B,W]."""
    a, b = _lru_gates(x1, lp)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x1.dtype)[:, None], h_new


def _lru_block(x, lp, *, conv_state=None, h0=None, decode=False):
    """Full recurrent mixer: gelu gate branch * (conv -> rg-lru) branch."""
    h = rms_norm(x, lp["ln1"])
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(h @ lp["w_y"], approximate="tanh")
    u = h @ lp["w_x"]
    u, new_conv = _causal_conv(u, lp["conv"], conv_state)
    if decode:
        r, new_h = _lru_step(u, lp, h0)
    else:
        r, new_h = _lru_scan(u, lp, h0)
    out = (r * y) @ lp["w_out"]
    return x + out, (new_conv, new_h)


def _mlp(x, lp):
    h = rms_norm(x, lp["ln2"])
    y = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return x + y @ lp["w_down"]


def _attn_block(cfg: ModelConfig, x, lp, sin, cos):
    B, S, _ = x.shape
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    h = rms_norm(x, lp["ln1"])
    q = apply_rope((h @ lp["wq"]).reshape(B, S, Hq, hd), sin, cos)
    k = apply_rope((h @ lp["wk"]).reshape(B, S, KV, hd), sin, cos)
    v = (h @ lp["wv"]).reshape(B, S, KV, hd)
    # the reference runs the blocked XLA attention here whatever
    # attention_impl says (and the CUDA flash kernel takes head dims 64 and
    # 128 only; this family's is 256)
    out = flash_attention_xla(q, k, v, causal=True, window=cfg.local_window,
                              block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    return x + out.reshape(B, S, Hq * hd) @ lp["wo"], (k, v)


def _split_stacks(params, cfg: ModelConfig):
    """``groups``, one (lru, lru, attn) triple of per-layer parameter dicts
    per local-attention layer (the reference's ``[n_groups, 2, ...]``
    recurrent body beside its attention stack), and ``tail``, the
    recurrent layers past the last group."""
    lru = unstack_layers(params, "lru")
    attn = unstack_layers(params, "attn")
    groups = [(lru[2 * g], lru[2 * g + 1], ap) for g, ap in enumerate(attn)]
    return groups, lru[2 * len(attn):]


# ------------------------------------------------------------------ train
def forward_hidden(params, cfg: ModelConfig, x, sin, cos):
    """All layers in the reference's order, x [B, S, D] -> final-normed
    hidden [B, S, D].  Under autograd with ``cfg.remat`` each (lru, lru,
    local) group is checkpointed, its activations (and its two scans)
    recomputed in the backward pass; the tail layers are not."""
    groups, tail = _split_stacks(params, cfg)
    # a checkpointed span is recomputed on the autograd engine's thread (a
    # card's own), which does not see this thread's context: each span
    # installs the one its forward ran under
    ctx = mesh_context()

    def group(x, g):
        lp0, lp1, ap = groups[g]
        with use_mesh_context(ctx):
            for lp in (lp0, lp1):
                x, _ = _lru_block(x, lp)
                x = _mlp(x, lp)
            x, _ = _attn_block(cfg, x, ap, sin, cos)
            return _mlp(x, ap)

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(len(groups)):
        x = (checkpoint(group, x, g, use_reentrant=False) if remat
             else group(x, g))
    for lp in tail:
        x, _ = _lru_block(x, lp)
        x = _mlp(x, lp)
    return rms_norm(x, params["final_norm"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy over the masked positions, through the
    bf16 copy of the (tied) table, as the reference; metrics ``{}``.  The
    gather is ``index_select``, whose backward on a card is deterministic
    under ``torch.use_deterministic_algorithms``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = torch.index_select(params["embed"], 0, tokens.reshape(-1).long())
    x = _embed_scale(cfg, x.reshape(B, S, -1))
    pos = torch.arange(S, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, S)
    sin, cos = rope_angles(pos, cfg.head_dim_, cfg.rope_theta)
    hidden = forward_hidden(params, cfg, x, sin, cos)
    total, count = chunked_softmax_xent(
        hidden, params["embed"].to(torch.bfloat16).t(), batch["targets"],
        batch["mask"], chunk=cfg.vocab_chunk or min(512, S))
    return total / torch.clamp(count, min=1.0), {}


def _logits(params, x):
    hidden = rms_norm(x, params["final_norm"])
    # f32 unembedding with no bf16 round trip of the table
    return hidden[:, -1].float() @ params["embed"].float().t()


# ---------------------------------------------------------------- serving
def cache_specs(cfg: ModelConfig, B: int, Smax: int) -> dict[str, BatchSpec]:
    n_lru, n_attn = _counts(cfg)
    W = cfg.lru_width or cfg.d_model
    win = min(cfg.local_window, Smax)
    return {
        "k": BatchSpec((n_attn, B, win, cfg.num_kv_heads, cfg.head_dim_),
                       cfg.dtype),
        "v": BatchSpec((n_attn, B, win, cfg.num_kv_heads, cfg.head_dim_),
                       cfg.dtype),
        "h": BatchSpec((n_lru, B, W), "float32"),
        "conv": BatchSpec((n_lru, B, cfg.conv_width - 1, W), cfg.dtype),
        "length": BatchSpec((), "int32"),
    }


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """Layer-by-layer prefill filling ring-buffer caches; returns
    (last-token logits [B, V] f32, cache).  As in the reference, a prompt
    longer than the window keeps its last ``win`` keys in order in slots
    0..win-1, and a shorter one fills slots 0..S-1."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    Smax = Smax or S
    win = min(cfg.local_window, Smax)
    dev = params["embed"].device
    dtype = getattr(torch, cfg.dtype)
    x = _embed_scale(cfg, params["embed"][tokens.long()])
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    sin, cos = rope_angles(pos, cfg.head_dim_, cfg.rope_theta)
    n_lru, n_attn = _counts(cfg)
    W = cfg.lru_width or cfg.d_model
    kv_shape = (n_attn, B, win, cfg.num_kv_heads, cfg.head_dim_)
    cache = {
        "k": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "v": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "h": torch.empty((n_lru, B, W), dtype=F32, device=dev),
        "conv": torch.empty((n_lru, B, cfg.conv_width - 1, W), dtype=dtype,
                            device=dev),
        "length": torch.tensor(S, dtype=torch.int32, device=dev),
    }
    keep = min(win, S)
    lru_i = attn_i = 0
    for kind in cfg.layer_kinds():
        if kind == "lru":
            lp = _stack_slice(params, "lru", lru_i)
            x, (cstate, h) = _lru_block(x, lp)
            x = _mlp(x, lp)
            cache["h"][lru_i] = h
            cache["conv"][lru_i] = cstate
            lru_i += 1
        else:
            ap = _stack_slice(params, "attn", attn_i)
            x, (k, v) = _attn_block(cfg, x, ap, sin, cos)
            x = _mlp(x, ap)
            cache["k"][attn_i, :, :keep] = k[:, S - keep:]
            cache["v"][attn_i, :, :keep] = v[:, S - keep:]
            attn_i += 1
    return _logits(params, x), cache


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token in, one token's logits out, for the whole batch in step.

    batch: token [B, 1], pos [B]; ``cache["length"]`` is 0-d.  The new
    token's k/v go to ring slot ``length % win``.  Unlike the reference,
    which returns a new cache, the k/v slot, the recurrent states ``h`` and
    the conv states are written into the cache's tensors IN PLACE; the
    returned dict shares them and carries ``length + 1``."""
    B = batch["token"].shape[0]
    win = cache["k"].shape[2]
    length = cache["length"]
    x = _embed_scale(cfg, params["embed"][batch["token"].long()])
    sin, cos = rope_angles(batch["pos"][:, None], cfg.head_dim_,
                           cfg.rope_theta)
    Hq, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    slot = (length % win).reshape(1).long()
    lru_i = attn_i = 0
    for kind in cfg.layer_kinds():
        if kind == "lru":
            lp = _stack_slice(params, "lru", lru_i)
            x, (cstate, h) = _lru_block(x, lp, conv_state=cache["conv"][lru_i],
                                        h0=cache["h"][lru_i], decode=True)
            x = _mlp(x, lp)
            cache["h"][lru_i] = h
            cache["conv"][lru_i] = cstate
            lru_i += 1
        else:
            ap = _stack_slice(params, "attn", attn_i)
            h_in = rms_norm(x, ap["ln1"])
            q = apply_rope((h_in @ ap["wq"]).reshape(B, 1, Hq, hd), sin, cos)
            k1 = apply_rope((h_in @ ap["wk"]).reshape(B, 1, KV, hd), sin, cos)
            v1 = (h_in @ ap["wv"]).reshape(B, 1, KV, hd)
            kc, vc = cache["k"][attn_i], cache["v"][attn_i]   # views
            kc.index_copy_(1, slot, k1)
            vc.index_copy_(1, slot, v1)
            # ring buffer: all filled slots are within the window by
            # construction, so plain length masking suffices
            out = decode_attention(q, kc, vc, torch.clamp(length + 1, max=win))
            x = x + out.reshape(B, 1, Hq * hd) @ ap["wo"]
            x = _mlp(x, ap)
            attn_i += 1
    new_cache = dict(cache, length=length + 1)
    return _logits(params, x), new_cache


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
        loss=lambda params, batch: loss_fn(params, cfg, batch),
        input_specs=functools.partial(token_batch_specs, cfg),
    )
