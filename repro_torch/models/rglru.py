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

Where the sharded train, prefill or decode step splits the compute over
the model axis, each activation lies where the reference's ``shard_hint``
puts it (:class:`_Split`): the attention, the MLPs, the embedding and the
loss as in the transformer family (``models/transformer.py``; one kv
head, so each process attends with its query heads against k and v
whole), and the recurrent block on this process's channels of its width
(``mlp``): the gelu branch, the conv, the scan (the ``rglru_scan`` kernel
on ``[B, S, W / n]``) and the states.  Its gates' products contract over
the split width (``w_a``, ``w_i`` stored row-split), so each is a partial
sum, reduce-scattered to this process's channels; ``w_out``'s rows give a
partial sum that the residual's hint reduces.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.context import (cache_split, mesh_context,
                                         model_axis, model_split, shard_hint,
                                         split_of, use_mesh_context)
from repro_torch.distrib.tensor_parallel import (copy_to_group,
                                                 gather_from_group,
                                                 split_to_group,
                                                 sum_scatter_to_group)
from repro_torch.kernels.rglru_scan.ops import lru_scan_vjp
from repro_torch.models.api import (
    BatchSpec,
    ParamSpec,
    TorchModelApi,
    token_batch_specs,
)
from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    chunked_softmax_xent,
    decode_attention,
    flash_attention_xla,
    rms_norm,
    rope_angles,
    softplus,
    unstack_layers,
    write_token,
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


# ------------------------------------------------------ tensor parallelism
#: the recurrent block's parameters the rule table splits on ``mlp``, as
#: their width: w_y and w_x by column, the conv and lam by channel, w_a,
#: w_i and w_out by row
_LRU_KEYS = ("w_y", "w_x", "conv", "lam", "w_a", "w_i", "w_out")
_FFN_KEYS = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class _Split(T._Split):
    """The transformer's split of the attention, the MLPs and the vocab
    (``models/transformer.py::_Split``), and ``lru``: the recurrent block's
    width split over the model axis (the gelu branch y, the conv's input u,
    the scan and its states on this process's channels; every parameter
    of ``_LRU_KEYS`` this process's part)."""
    lru: bool = False


NO_SPLIT = _Split()


def _split(cfg: ModelConfig) -> _Split:
    """The step's split under the installed context (see ``_Split``)."""
    if model_axis() is None:
        return NO_SPLIT
    base = T._split(cfg)
    W = cfg.lru_width or cfg.d_model
    specs = param_specs(cfg)
    lru = model_split(("batch", None, "mlp"), (1, 1, W)) is not None and all(
        model_split(specs[f"lru/{k}"].axes, specs[f"lru/{k}"].shape)
        == specs[f"lru/{k}"].axes.index("mlp") for k in _LRU_KEYS)
    return _Split(**{f.name: getattr(base, f.name)
                     for f in dataclasses.fields(base)}, lru=lru)


def split_params(cfg: ModelConfig) -> set[str]:
    """The parameters the loss, the prefill and the decode step take as
    this process's part of their model split under the installed context;
    they take every other parameter whole."""
    s = _split(cfg)
    names = ({"attn/wq"} if s.q else set()) | (
        {"attn/wk", "attn/wv"} if s.kv else set())
    names |= {"attn/wo"} if s.out else set()
    names |= ({f"{pre}/{k}" for pre in ("lru", "attn") for k in _FFN_KEYS}
              if s.mlp else set())
    names |= {"embed"} if s.vocab else set()
    return names | ({f"lru/{k}" for k in _LRU_KEYS} if s.lru else set())


def _check_state_split(cfg: ModelConfig, s: _Split) -> None:
    """The sharded decode step's recurrent and conv states must lie as the
    step's own channels: split over the model axis with the width (raises
    otherwise)."""
    W = cfg.lru_width or cfg.d_model
    want = None
    if s.lru:
        part = split_of(W)
        want = (part.start, part.stop)
    for entry, dim in (("h", 2), ("conv", 3)):
        sp = cache_split(entry, dim)
        if (None if sp is None else (sp.start, sp.stop)) != want:
            raise NotImplementedError(
                f"cache entry {entry!r} split {sp}: the decode step runs "
                f"the channels {want} (None: every one)")


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


def _lru_gates(x, lp, s: _Split = NO_SPLIT):
    """(a, b) of the recurrence over x's channels.  Under ``s.lru`` x is
    this process's channels and ``w_a``, ``w_i`` its rows: the products
    are partial sums over the contraction, and one reduce-scatter leaves
    each process the summed gates of its own channels."""
    # f32 products, as the reference's x.astype(F32) @ w.astype(F32); they
    # stay full f32 on the card while torch.backends.cuda.matmul.allow_tf32
    # keeps its default (False)
    xf = x.float()
    ra, ia = xf @ lp["w_a"].float(), xf @ lp["w_i"].float()
    if s.lru:
        ra, ia = sum_scatter_to_group(torch.stack([ra, ia]), s.group,
                                      ra.dim()).unbind(0)
    r, i = torch.sigmoid(ra), torch.sigmoid(ia)
    log_a = -C_CONST * softplus(lp["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return a, b


def _lru_scan(x, lp, h0=None, s: _Split = NO_SPLIT):
    """x [B,S,W] -> (y [B,S,W] in x's dtype, h_last [B,W] f32), through the
    ``rglru_scan`` kernel (under autograd), on x's channels."""
    a, b = _lru_gates(x, lp, s)
    h, h_last = lru_scan_vjp(a, b, None if h0 is None else h0.float())
    return h.to(x.dtype), h_last


def _lru_step(x1, lp, h, s: _Split = NO_SPLIT):
    """Single decode step: x1 [B,1,W], h [B,W] (x1's channels)."""
    a, b = _lru_gates(x1, lp, s)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x1.dtype)[:, None], h_new


def _lru_block(cfg: ModelConfig, x, lp, *, conv_state=None, h0=None,
               decode=False, s: _Split = NO_SPLIT):
    """Full recurrent mixer: gelu gate branch * (conv -> rg-lru) branch.
    Under ``s.lru`` the branches, the conv, the scan (or the decode step)
    and the states run on this process's channels, and ``w_out``'s rows
    give a partial sum that the residual's hint reduces."""
    B, S, D = x.shape
    W = cfg.lru_width or D
    h = rms_norm(x, lp["ln1"])
    hs = copy_to_group(h, s.group) if s.lru else h
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(hs @ lp["w_y"], approximate="tanh")
    u = hs @ lp["w_x"]
    if s.lru:
        y = shard_hint(y, ("batch", None, "mlp"), (B, S, W))
        u = shard_hint(u, ("batch", None, "mlp"), (B, S, W))
    u, new_conv = _causal_conv(u, lp["conv"], conv_state)
    if decode:
        r, new_h = _lru_step(u, lp, h0, s)
    else:
        r, new_h = _lru_scan(u, lp, h0, s)
    out = (r * y) @ lp["w_out"]
    return x + shard_hint(out, ("batch", None, None), (B, S, D),
                          partial=s.lru), (new_conv, new_h)


def _mlp(cfg: ModelConfig, x, lp, s: _Split = NO_SPLIT):
    return T._ffn(cfg, x, lp, s=s)[0]


def _attn_block(cfg: ModelConfig, x, lp, sin, cos, s: _Split = NO_SPLIT):
    """x + the local attention of x, and its (k, v) [B, S, KV, hd] (this
    process's kv heads where they are split): the transformer's q, k, v,
    heads and output by their hints (one kv head, so under the model axis
    each process attends with its query heads against k and v whole)."""
    B, S, D = x.shape
    q, k, v = T._qkv(cfg, x, lp, sin, cos, s=s)
    qa, ka, va = T._attention_heads(cfg, s, q, k, v)
    # the reference runs the blocked XLA attention here whatever
    # attention_impl says (and the CUDA flash kernel takes head dims 64 and
    # 128 only; this family's is 256)
    out = flash_attention_xla(qa, ka, va, causal=True,
                              window=cfg.local_window,
                              block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    out = T._attention_out(cfg, s, out)
    return x + shard_hint(out @ lp["wo"], ("batch", None, None), (B, S, D),
                          partial=s.out), (k, v)


def _split_stacks(params, cfg: ModelConfig):
    """``groups``, one (lru, lru, attn) triple of per-layer parameter dicts
    per local-attention layer (the reference's ``[n_groups, 2, ...]``
    recurrent body beside its attention stack), and ``tail``, the
    recurrent layers past the last group."""
    lru = unstack_layers(params, "lru")
    attn = unstack_layers(params, "attn")
    groups = [(lru[2 * g], lru[2 * g + 1], ap) for g, ap in enumerate(attn)]
    return groups, lru[2 * len(attn):]


def _embed_in(params, cfg: ModelConfig, tokens, s: _Split):
    """The tokens' scaled embeddings [B, S, D] (looked up in this process's
    vocab rows and summed where the vocab is split) and their rope."""
    B, S = tokens.shape
    x = _embed_scale(cfg, T._lookup(params, cfg, tokens, s=s))
    pos = torch.arange(S, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, S)
    return x, rope_angles(pos, cfg.head_dim_, cfg.rope_theta)


# ------------------------------------------------------------------ train
def forward_hidden(params, cfg: ModelConfig, x, sin, cos, *,
                   s: _Split = NO_SPLIT):
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
                x, _ = _lru_block(cfg, x, lp, s=s)
                x = _mlp(cfg, x, lp, s)
            x, _ = _attn_block(cfg, x, ap, sin, cos, s)
            return _mlp(cfg, x, ap, s)

    remat = cfg.remat and torch.is_grad_enabled()
    for g in range(len(groups)):
        x = (checkpoint(group, x, g, use_reentrant=False) if remat
             else group(x, g))
    for lp in tail:
        x, _ = _lru_block(cfg, x, lp, s=s)
        x = _mlp(cfg, x, lp, s)
    return rms_norm(x, params["final_norm"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy over the masked positions, through the
    bf16 copy of the (tied) table, as the reference (vocab-parallel where
    the vocab is split); metrics ``{}``.  The gather is ``index_select``,
    whose backward on a card is deterministic under
    ``torch.use_deterministic_algorithms``."""
    s = _split(cfg)
    x, (sin, cos) = _embed_in(params, cfg, batch["tokens"], s)
    hidden = forward_hidden(params, cfg, x, sin, cos, s=s)
    total, count = chunked_softmax_xent(
        copy_to_group(hidden, s.group) if s.vocab else hidden,
        params["embed"].to(torch.bfloat16).t(), batch["targets"],
        batch["mask"], chunk=cfg.vocab_chunk or min(512, hidden.shape[1]),
        vocab=split_of(cfg.vocab) if s.vocab else None)
    return total / torch.clamp(count, min=1.0), {}


def _logits(params, x, s: _Split = NO_SPLIT):
    hidden = rms_norm(x, params["final_norm"])
    # f32 unembedding with no bf16 round trip of the table
    logits = hidden[:, -1].float() @ params["embed"].float().t()
    return gather_from_group(logits, s.group, 1) if s.vocab else logits


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


def cache_axes(cfg: ModelConfig):
    """The ring buffer's slots are ``kv_seq``; the recurrent and conv
    states' width is ``mlp``."""
    return {"k": ("layers", "batch", "kv_seq", "kv_heads", None),
            "v": ("layers", "batch", "kv_seq", "kv_heads", None),
            "h": ("layers", "batch", "mlp"),
            "conv": ("layers", "batch", None, "mlp"),
            "length": ()}


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """Layer-by-layer prefill filling ring-buffer caches; returns
    (last-token logits [B, V] f32, cache).  As in the reference, a prompt
    longer than the window keeps its last ``win`` keys in order in slots
    0..win-1, and a shorter one fills slots 0..S-1.  Under the model axis
    (``_split``) the states ``h`` and ``conv`` are this process's channels
    and the ring holds every kv head."""
    s = _split(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    Smax = Smax or S
    win = min(cfg.local_window, Smax)
    dev = params["embed"].device
    dtype = getattr(torch, cfg.dtype)
    x, (sin, cos) = _embed_in(params, cfg, tokens, s)
    n_lru, n_attn = _counts(cfg)
    W = cfg.lru_width or cfg.d_model
    Wp = W // model_axis().size if s.lru else W
    KV = cfg.num_kv_heads
    kv_shape = (n_attn, B, win, KV, cfg.head_dim_)
    cache = {
        "k": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "v": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "h": torch.empty((n_lru, B, Wp), dtype=F32, device=dev),
        "conv": torch.empty((n_lru, B, cfg.conv_width - 1, Wp), dtype=dtype,
                            device=dev),
        "length": torch.tensor(S, dtype=torch.int32, device=dev),
    }
    keep = min(win, S)
    lru_i = attn_i = 0
    for kind in cfg.layer_kinds():
        if kind == "lru":
            lp = _stack_slice(params, "lru", lru_i)
            x, (cstate, h) = _lru_block(cfg, x, lp, s=s)
            x = _mlp(cfg, x, lp, s)
            cache["h"][lru_i] = h
            cache["conv"][lru_i] = cstate
            lru_i += 1
        else:
            ap = _stack_slice(params, "attn", attn_i)
            x, (k, v) = _attn_block(cfg, x, ap, sin, cos, s)
            x = _mlp(cfg, x, ap, s)
            k, v = T._whole(k, s.group, 2, KV), T._whole(v, s.group, 2, KV)
            cache["k"][attn_i, :, :keep] = k[:, S - keep:]
            cache["v"][attn_i, :, :keep] = v[:, S - keep:]
            attn_i += 1
    return _logits(params, x, s), cache


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token in, one token's logits out, for the whole batch in step.

    batch: token [B, 1], pos [B]; ``cache["length"]`` is 0-d.  The new
    token's k/v go to ring slot ``length % win``.  Unlike the reference,
    which returns a new cache, the k/v slot, the recurrent states ``h`` and
    the conv states are written into the cache's tensors IN PLACE; the
    returned dict shares them and carries ``length + 1``.  Under the
    sharded decode step the cache is this process's shard: the ring's
    slots split on ``kv_seq``, ``h`` and ``conv`` on ``mlp``.

    Where the step splits the compute over the model axis (``_split``, as
    the prefill does), the recurrent block steps this process's channels
    (its shard of ``h`` and ``conv``, the gates' partial products
    reduce-scattered to them), the attention computes q on this process's
    heads and gathers the one token's q (k and v are whole: one kv head)
    to meet the ring's slots it holds, the MLPs run column-split, each
    partial reduced at the residual's hint, and the logits are
    vocab-split and gathered."""
    s = _split(cfg)
    _check_state_split(cfg, s)
    B = batch["token"].shape[0]
    sp = cache_split("k", 2)
    win = sp.size if sp is not None else cache["k"].shape[2]
    length = cache["length"]
    x = _embed_scale(cfg, T._lookup(params, cfg, batch["token"], s=s))
    sin, cos = rope_angles(batch["pos"][:, None], cfg.head_dim_,
                           cfg.rope_theta)
    Hq, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    slot = length % win
    lru_i = attn_i = 0
    for kind in cfg.layer_kinds():
        if kind == "lru":
            lp = _stack_slice(params, "lru", lru_i)
            x, (cstate, h) = _lru_block(cfg, x, lp,
                                        conv_state=cache["conv"][lru_i],
                                        h0=cache["h"][lru_i], decode=True,
                                        s=s)
            x = _mlp(cfg, x, lp, s)
            cache["h"][lru_i] = h
            cache["conv"][lru_i] = cstate
            lru_i += 1
        else:
            ap = _stack_slice(params, "attn", attn_i)
            q, k1, v1 = T._qkv(cfg, x, ap, sin, cos, s=s)
            q, k1, v1 = (T._whole(q, s.group, 2, Hq),
                         T._whole(k1, s.group, 2, KV),
                         T._whole(v1, s.group, 2, KV))
            kc, vc = cache["k"][attn_i], cache["v"][attn_i]   # views
            write_token(kc, k1, slot, entry="k")
            write_token(vc, v1, slot, entry="v")
            # ring buffer: all filled slots are within the window by
            # construction, so plain length masking suffices
            out = decode_attention(q, kc, vc, torch.clamp(length + 1, max=win),
                                   entry="k").reshape(B, 1, -1)
            if s.out:
                out = split_to_group(out, s.group, 2)
            x = x + shard_hint(out @ ap["wo"], ("batch", None, None),
                               (B, 1, D), partial=s.out)
            x = _mlp(cfg, x, ap, s)
            attn_i += 1
    new_cache = dict(cache, length=length + 1)
    return _logits(params, x, s), new_cache


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
