"""xLSTM family: alternating mLSTM (matrix memory, parallel over time) and
sLSTM (scalar memory, sequential) blocks, attention-free with an O(1)
decode state — the counterpart of the JAX package's ``models/xlstm.py``.

mLSTM runs in chunkwise form (gated linear attention): within a chunk the
quadratic form with cumulative decays, across chunks a recurrent matrix
state [H, hd, hd], in f32.  sLSTM is the stabilised exponential-gating
recurrence (running max m_t) with a per-head block-diagonal recurrent
matrix, a Python loop over time.  Both are plain PyTorch: no TPU kernel
lies on this family's path in the reference either.

Parameters keep the reference's stacked ``[n, ...]`` layout (``m/*`` for
the mLSTM blocks, ``s/*`` for the sLSTM blocks) and its precision
choices.  One formulation differs from the reference's text and not in
value: the within-chunk prefix sum of the log forget gates is a product
with a lower-triangular ones matrix (``torch.cumsum`` on a card has no
deterministic implementation, and the train path runs in PyTorch's
deterministic mode).  A decode step returns new state tensors, as the
reference does (the port's other families write their caches in place).

Where the sharded train, prefill or decode step splits the compute over
the model axis, each activation lies where the reference's ``shard_hint``
puts it (:class:`_Split`).  The rule table keeps xLSTM's heads whole, so
the mLSTM block runs its up-projections, its gate and its down-projection
on this process's columns of the inner width (``mlp``): ``wq``, ``wk``,
``wv`` and ``w_if`` are stored row-split, so q, k, v and the gates are
partial sums, summed whole in one exchange, and the chunkwise cell runs
whole on every process (the state ``m_state`` is whole on the model axis,
as the table places it).  The sLSTM block computes its gates' pre-
activations on this process's columns of 4D (one gate of every channel
where the axis is 4 wide), gathers them once and runs the time loop
whole; ``w_out``'s rows give a partial sum.  Each block's partial output
is reduced at the residual's hint, and the embedding and the logits split
the vocab as the transformer family's do.
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
                                                 reduce_from_group,
                                                 split_to_group)
from repro_torch.models.api import (
    BatchSpec,
    ParamSpec,
    TorchModelApi,
    token_batch_specs,
)
from repro_torch.models import transformer as T
from repro_torch.models.layers import (
    chunked_softmax_xent,
    rms_norm,
    softplus,
    unstack_layers,
)

F32 = torch.float32


def _counts(cfg: ModelConfig) -> tuple[int, int]:
    kinds = cfg.layer_kinds()
    return sum(k == "mlstm" for k in kinds), sum(k == "slstm" for k in kinds)


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    D, H, V = cfg.d_model, cfg.num_heads, cfg.vocab
    Di = 2 * D                       # mLSTM inner width (up-projection x2)
    n_m, n_s = _counts(cfg)
    dt = cfg.dtype
    return {
        "embed": ParamSpec((V, D), ("vocab", "embed"), dt),
        "final_norm": ParamSpec((D,), ("embed",), dt, init="zeros"),
        # mLSTM blocks
        "m/ln": ParamSpec((n_m, D), ("layers", "embed"), dt, init="zeros"),
        "m/w_up": ParamSpec((n_m, D, Di), ("layers", "embed", "mlp"), dt),
        "m/w_gate": ParamSpec((n_m, D, Di), ("layers", "embed", "mlp"), dt),
        "m/wq": ParamSpec((n_m, Di, Di), ("layers", "mlp", "heads"), dt),
        "m/wk": ParamSpec((n_m, Di, Di), ("layers", "mlp", "heads"), dt),
        "m/wv": ParamSpec((n_m, Di, Di), ("layers", "mlp", "heads"), dt),
        "m/w_if": ParamSpec((n_m, Di, 2 * H), ("layers", "mlp", None), dt),
        "m/w_down": ParamSpec((n_m, Di, D), ("layers", "mlp", "embed"), dt),
        # sLSTM blocks (4 gates: i, f, z, o), per-head recurrent matrices
        "s/ln": ParamSpec((n_s, D), ("layers", "embed"), dt, init="zeros"),
        "s/w": ParamSpec((n_s, D, 4 * D), ("layers", "embed", "mlp"), dt),
        "s/r": ParamSpec((n_s, H, D // H, 4 * (D // H)),
                         ("layers", "heads", None, None), dt),
        "s/b": ParamSpec((n_s, 4 * D), ("layers", "mlp"), dt, init="zeros"),
        "s/w_out": ParamSpec((n_s, D, D), ("layers", "mlp", "embed"), dt),
    }


# ------------------------------------------------------ tensor parallelism
#: each block's parameters the rule table splits on ``mlp``: the mLSTM's
#: up-projection and gate by column, its q, k, v, gate and down
#: projections by row; the sLSTM's input product and bias by gate column,
#: its output product by row
_M_KEYS = ("w_up", "w_gate", "wq", "wk", "wv", "w_if", "w_down")
_S_KEYS = ("w", "b", "w_out")


@dataclasses.dataclass(frozen=True)
class _Split(T._Split):
    """The transformer's split of the vocab (``models/transformer.py::
    _Split``: the embedding looked up in this process's rows, the logits
    on its columns), and each block's split over the model axis: ``m``,
    the mLSTM's inner width (u and its gate on this process's columns;
    every parameter of ``_M_KEYS`` its part); ``s``, the sLSTM's gate
    columns (its pre-activations on this process's columns, ``w_out`` on
    its rows; every parameter of ``_S_KEYS`` its part)."""
    m: bool = False
    s: bool = False


NO_SPLIT = _Split()


def _block_split(specs, prefix: str, keys, width: int) -> bool:
    """Whether the installed context splits the block's ``mlp`` activation
    of ``width`` over the model axis; where it does, each of its
    parameters must be stored split on its ``mlp`` dim (raises, naming
    the block and the parameter, otherwise)."""
    if model_split(("batch", None, "mlp"), (1, 1, width)) is None:
        return False
    for k in keys:
        spec = specs[f"{prefix}/{k}"]
        if model_split(spec.axes, spec.shape) != spec.axes.index("mlp"):
            raise NotImplementedError(
                f"the {prefix!r} block's activation of width {width} is "
                f"split over the model axis but {prefix}/{k} is not stored "
                f"split on its mlp dim: the block takes no other split")
    return True


def _split(cfg: ModelConfig) -> _Split:
    """The step's split under the installed context (see ``_Split``)."""
    ax = model_axis()
    if ax is None:
        return NO_SPLIT
    D, V = cfg.d_model, cfg.vocab
    specs = param_specs(cfg)
    vocab = (model_split(("batch", None, "vocab"), (1, 1, V)) is not None
             and model_split(specs["embed"].axes, specs["embed"].shape) == 0)
    return _Split(vocab=vocab, m=_block_split(specs, "m", _M_KEYS, 2 * D),
                  s=_block_split(specs, "s", _S_KEYS, 4 * D), group=ax.group)


def split_params(cfg: ModelConfig) -> set[str]:
    """The parameters the loss, the prefill and the decode step take as
    this process's part of their model split under the installed context;
    they take every other parameter whole (the norms, the sLSTM's
    recurrent matrices)."""
    s = _split(cfg)
    names = {f"m/{k}" for k in _M_KEYS} if s.m else set()
    names |= {f"s/{k}" for k in _S_KEYS} if s.s else set()
    return names | ({"embed"} if s.vocab else set())


# ------------------------------------------------------------------- mLSTM
def _mlstm_chunk(q, k, v, log_f, log_i, state, norm, chunk: int):
    """Chunkwise gated linear attention.

    q, k, v [B,S,H,hd]; log_f, log_i [B,S,H]; state [B,H,hd,hd]; norm
    [B,H,hd].  Returns (y [B,S,H,hd] f32, state', norm').  A ragged last
    chunk is padded with log_i = -30 (no write) and log_f = 0."""
    B, S, H, hd = q.shape
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-30.0)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    ones_tri = tri.to(F32)
    root = math.sqrt(hd)
    S_st, n_st = state.float(), norm.float()
    ys = []
    for j in range(n):
        part = slice(j * chunk, (j + 1) * chunk)
        qi, ki, vi = q[:, part].float(), k[:, part].float(), v[:, part].float()
        fi, ii = log_f[:, part], log_i[:, part]             # [B,c,H]
        # within-chunk decay prefix: csum_t = sum_{s<=t} log_f_s
        csum = torch.einsum("ts,bsh->bth", ones_tri, fi)
        total = csum[:, -1]                                  # [B,H]
        # intra-chunk quadratic term with relative decay
        # D[t,s] = exp(csum_t - csum_s + log_i_s) for s <= t; the mask goes
        # in before exp, so no inf reaches a gradient
        rel = csum[:, :, None] - csum[:, None] + ii[:, None]
        rel = torch.where(tri[None, :, :, None], rel, -torch.inf)
        gate = torch.exp(rel)                                # [B,t,s,H]
        scores = torch.einsum("bthd,bshd->btsh", qi, ki) / root
        intra = torch.einsum("btsh,btsh,bshd->bthd", scores, gate, vi)
        # inter-chunk: contribution of the carried state
        qdec = qi * torch.exp(csum)[..., None] / root
        inter = torch.einsum("bthd,bhde->bthe", qdec, S_st)
        # normaliser n_t = decayed sum of gated keys; denom = max(|q.n_t|, 1)
        norm_inter = torch.einsum("bthd,bhd->bth", qdec, n_st)
        norm_intra = torch.einsum("btsh,btsh->bth", scores, gate)
        denom = torch.clamp(torch.abs(norm_inter + norm_intra), min=1.0)
        ys.append((intra + inter) / denom[..., None])
        # S' = exp(total) S + sum_s exp(total - csum_s + i_s) k v^T
        w = torch.exp(total[:, None] - csum + ii)            # [B,c,H]
        decay = torch.exp(total)
        S_st = decay[..., None, None] * S_st + torch.einsum(
            "bshd,bsh,bshe->bhde", ki, w, vi)
        n_st = decay[..., None] * n_st + torch.einsum("bshd,bsh->bhd", ki, w)
    y = torch.cat(ys, dim=1)[:, :S]
    return y, S_st, n_st


def _mlstm_block(x, lp, *, state=None, norm=None, chunk=128, decode=False,
                 s: _Split = NO_SPLIT):
    """x + the mLSTM of x, and its (state, norm).  Under ``s.m`` u and the
    gate are this process's columns of the inner width and ``wq``, ``wk``,
    ``wv``, ``w_if`` its rows: q, k, v and the gates' products are
    partial sums, summed whole, so the cell runs on every head on every
    process; its output meets the gate and ``w_down``'s rows on this
    process's columns, a partial sum that the residual's hint reduces."""
    B, S, D = x.shape
    Di = 2 * D
    H = lp["w_if"].shape[-1] // 2
    hd = Di // H
    h = rms_norm(x, lp["ln"])
    hs = copy_to_group(h, s.group) if s.m else h
    u = hs @ lp["w_up"]
    gate = F.silu(hs @ lp["w_gate"])
    if s.m:
        u = shard_hint(u, ("batch", None, "mlp"), (B, S, Di))
        gate = shard_hint(gate, ("batch", None, "mlp"), (B, S, Di))
    q, k, v = u @ lp["wq"], u @ lp["wk"], u @ lp["wv"]
    # f32 gate products, as the reference's x.astype(F32) @ w.astype(F32)
    gif = u.float() @ lp["w_if"].float()
    if s.m and q.dtype == F32:
        q, k, v, gif = reduce_from_group(torch.cat([q, k, v, gif], -1),
                                         s.group).split((Di,) * 3 + (2 * H,),
                                                        -1)
    elif s.m:
        q, k, v = reduce_from_group(torch.stack([q, k, v]), s.group).unbind(0)
        gif = reduce_from_group(gif, s.group)
    q, k, v = (t.reshape(B, S, H, hd) for t in (q, k, v))
    gif = gif.reshape(B, S, H, 2)
    log_i = -softplus(-gif[..., 0])            # log sigmoid
    log_f = -softplus(-gif[..., 1])
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
        norm = torch.zeros((B, H, hd), dtype=F32, device=x.device)
    y, S_st, n_st = _mlstm_chunk(q, k, v, log_f, log_i, state, norm,
                                 chunk=1 if decode else chunk)
    y = shard_hint(y.reshape(B, S, Di).to(x.dtype),
                   ("batch", None, "mlp")) * gate
    return x + shard_hint(y @ lp["w_down"], ("batch", None, None),
                          (B, S, D), partial=s.m), (S_st, n_st)


# ------------------------------------------------------------------- sLSTM
def _slstm_block(x, lp, *, state=None, s: _Split = NO_SPLIT):
    """Sequential sLSTM over time: states (c, n, h, m) each [B, D] f32.
    Under ``s.s`` the pre-activations are this process's columns of the
    four gates laid end to end, gathered once, so the time loop runs on
    every channel on every process; its output meets ``w_out``'s rows on
    this process's part, a partial sum that the residual's hint
    reduces."""
    B, S, D = x.shape
    H = lp["r"].shape[0]                        # r [H, hd, 4*hd]
    hd = D // H
    xin = rms_norm(x, lp["ln"])
    xs = copy_to_group(xin, s.group) if s.s else xin
    pre = xs @ lp["w"] + lp["b"]                # [B,S,4D]
    if s.s:
        pre = gather_from_group(
            shard_hint(pre, ("batch", None, "mlp"), (B, S, 4 * D)), s.group, 2)
    pre = pre.float()
    if state is None:
        state = (torch.zeros((B, D), dtype=F32, device=x.device),
                 torch.full((B, D), 1e-6, dtype=F32, device=x.device),
                 torch.zeros((B, D), dtype=F32, device=x.device),
                 torch.full((B, D), -10.0, dtype=F32, device=x.device))
    r = lp["r"].float()
    c, n, h, m = state
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(B, H, hd),
                           r).reshape(B, 4 * D)
        zi, zf, zz, zo = (pre[:, t] + rec).chunk(4, dim=-1)
        m_new = torch.maximum(zf + m, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(zf + m - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = torch.sigmoid(zo) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)      # [B,S,D]
    if s.s:
        y = split_to_group(y, s.group, 2)
    return x + shard_hint(y @ lp["w_out"], ("batch", None, None), (B, S, D),
                          partial=s.s), (c, n, h, m)


# ------------------------------------------------------------------- train
def forward_hidden(params, cfg: ModelConfig, x, *, s: _Split = NO_SPLIT):
    """All (mLSTM, sLSTM) pairs, x [B, S, D] -> final-normed hidden.  Under
    autograd with ``cfg.remat`` each pair is checkpointed, as the
    reference's ``jax.checkpoint`` over its scanned pairs."""
    m_layers = unstack_layers(params, "m")
    s_layers = unstack_layers(params, "s")
    if len(m_layers) != len(s_layers):
        raise ValueError("the xlstm_alt pattern pairs each mLSTM block with "
                         "an sLSTM block")
    # a checkpointed span is recomputed on the autograd engine's thread (a
    # card's own), which does not see this thread's context: each span
    # installs the one its forward ran under
    ctx = mesh_context()

    def pair(x, i):
        with use_mesh_context(ctx):
            x, _ = _mlstm_block(x, m_layers[i], s=s)
            x, _ = _slstm_block(x, s_layers[i], s=s)
            return x

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(len(m_layers)):
        x = (checkpoint(pair, x, i, use_reentrant=False) if remat
             else pair(x, i))
    return rms_norm(x, params["final_norm"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy over the masked positions through the
    bf16 copy of the (tied) table, as the reference (which does not scale
    the embedding in this family; vocab-parallel where the vocab is split);
    metrics ``{}``.  The gather is ``index_select``, whose backward on a
    card is deterministic under ``torch.use_deterministic_algorithms``."""
    s = _split(cfg)
    tokens = batch["tokens"]
    x = T._lookup(params, cfg, tokens, s=s)
    hidden = forward_hidden(params, cfg, x, s=s)
    total, count = chunked_softmax_xent(
        copy_to_group(hidden, s.group) if s.vocab else hidden,
        params["embed"].to(torch.bfloat16).t(), batch["targets"],
        batch["mask"], chunk=cfg.vocab_chunk or min(512, tokens.shape[1]),
        vocab=split_of(cfg.vocab) if s.vocab else None)
    return total / torch.clamp(count, min=1.0), {}


# ----------------------------------------------------------------- serving
def cache_specs(cfg: ModelConfig, B: int, Smax: int) -> dict[str, BatchSpec]:
    """The O(1) serving state (``Smax`` does not enter it)."""
    D, H = cfg.d_model, cfg.num_heads
    hd = 2 * D // H
    n_m, n_s = _counts(cfg)
    return {
        "m_state": BatchSpec((n_m, B, H, hd, hd), "float32"),
        "m_norm": BatchSpec((n_m, B, H, hd), "float32"),
        "s_c": BatchSpec((n_s, B, D), "float32"),
        "s_n": BatchSpec((n_s, B, D), "float32"),
        "s_h": BatchSpec((n_s, B, D), "float32"),
        "s_m": BatchSpec((n_s, B, D), "float32"),
        "length": BatchSpec((), "int32"),
    }


def cache_axes(cfg: ModelConfig):
    """The state is whole on the model axis under every rule table that
    keeps the heads whole (xlstm's own)."""
    return {"m_state": ("layers", "batch", "heads", None, None),
            "m_norm": ("layers", "batch", "heads", None),
            "s_c": ("layers", "batch", "embed"),
            "s_n": ("layers", "batch", "embed"),
            "s_h": ("layers", "batch", "embed"),
            "s_m": ("layers", "batch", "embed"),
            "length": ()}


def _run(params, cfg: ModelConfig, tokens, cache, decode: bool):
    """Every layer over ``tokens`` [B, S] from ``cache`` (None: the zero
    state); returns (last-token logits [B, V] f32, the new state).  Under
    the model axis (``_split``) the blocks and the vocab split as in the
    train step, the state stays whole on every process (the sharded decode
    step refuses a split of it: ``train/step.py::decode_splits``) and the
    logits are gathered over the vocab."""
    B, S = tokens.shape
    s = _split(cfg)
    x = T._lookup(params, cfg, tokens, s=s)
    new = {k: [] for k in ("m_state", "m_norm", "s_c", "s_n", "s_h", "s_m")}
    for i, (mp, sp) in enumerate(zip(unstack_layers(params, "m"),
                                     unstack_layers(params, "s"))):
        mstate = ((cache["m_state"][i], cache["m_norm"][i]) if cache
                  else (None, None))
        x, (S_st, n_st) = _mlstm_block(x, mp, state=mstate[0],
                                       norm=mstate[1], decode=decode, s=s)
        sstate = ((cache["s_c"][i], cache["s_n"][i], cache["s_h"][i],
                   cache["s_m"][i]) if cache else None)
        x, (c, n, h, m) = _slstm_block(x, sp, state=sstate, s=s)
        for key, t in zip(new, (S_st, n_st, c, n, h, m)):
            new[key].append(t)
    hidden = rms_norm(x, params["final_norm"])
    # f32 unembedding with no bf16 round trip of the table
    logits = hidden[:, -1].float() @ params["embed"].float().t()
    if s.vocab:
        logits = gather_from_group(logits, s.group, 1)
    new_cache = {k: torch.stack(v) for k, v in new.items()}
    new_cache["length"] = (cache["length"] + S if cache else torch.tensor(
        S, dtype=torch.int32, device=tokens.device))
    return logits, new_cache


def prefill(params, cfg: ModelConfig, batch, Smax: int | None = None):
    """(last-token logits [B, V] f32, the state after the prompt)."""
    return _run(params, cfg, batch["tokens"], None, decode=False)


def decode_step(params, cfg: ModelConfig, cache, batch):
    """One token [B, 1] in (``batch["token"]``; positions are not used),
    one token's logits out, and a new state (the cache is not written)."""
    return _run(params, cfg, batch["token"], cache, decode=True)


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
