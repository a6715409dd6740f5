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
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.context import mesh_context, use_mesh_context
from repro_torch.models.api import (
    BatchSpec,
    ParamSpec,
    TorchModelApi,
    token_batch_specs,
)
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


def _mlstm_block(x, lp, *, state=None, norm=None, chunk=128, decode=False):
    B, S, D = x.shape
    h = rms_norm(x, lp["ln"])
    u = h @ lp["w_up"]
    gate = F.silu(h @ lp["w_gate"])
    Di = u.shape[-1]
    H = lp["w_if"].shape[-1] // 2
    hd = Di // H
    q = (u @ lp["wq"]).reshape(B, S, H, hd)
    k = (u @ lp["wk"]).reshape(B, S, H, hd)
    v = (u @ lp["wv"]).reshape(B, S, H, hd)
    # f32 gate products, as the reference's x.astype(F32) @ w.astype(F32)
    gif = (u.float() @ lp["w_if"].float()).reshape(B, S, H, 2)
    log_i = -softplus(-gif[..., 0])            # log sigmoid
    log_f = -softplus(-gif[..., 1])
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
        norm = torch.zeros((B, H, hd), dtype=F32, device=x.device)
    y, S_st, n_st = _mlstm_chunk(q, k, v, log_f, log_i, state, norm,
                                 chunk=1 if decode else chunk)
    y = y.reshape(B, S, Di).to(x.dtype) * gate
    return x + y @ lp["w_down"], (S_st, n_st)


# ------------------------------------------------------------------- sLSTM
def _slstm_block(x, lp, *, state=None):
    """Sequential sLSTM over time: states (c, n, h, m) each [B, D] f32."""
    B, S, D = x.shape
    H = lp["r"].shape[0]                        # r [H, hd, 4*hd]
    hd = D // H
    xin = rms_norm(x, lp["ln"])
    pre = (xin @ lp["w"] + lp["b"]).float()     # [B,S,4D]
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
    return x + y @ lp["w_out"], (c, n, h, m)


# ------------------------------------------------------------------- train
def forward_hidden(params, cfg: ModelConfig, x):
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
            x, _ = _mlstm_block(x, m_layers[i])
            x, _ = _slstm_block(x, s_layers[i])
            return x

    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(len(m_layers)):
        x = (checkpoint(pair, x, i, use_reentrant=False) if remat
             else pair(x, i))
    return rms_norm(x, params["final_norm"])


def loss_fn(params, cfg: ModelConfig, batch):
    """Mean next-token cross-entropy over the masked positions through the
    bf16 copy of the (tied) table, as the reference (which does not scale
    the embedding in this family); metrics ``{}``.  The gather is
    ``index_select``, whose backward on a card is deterministic under
    ``torch.use_deterministic_algorithms``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = torch.index_select(params["embed"], 0,
                           tokens.reshape(-1).long()).reshape(B, S, -1)
    hidden = forward_hidden(params, cfg, x)
    total, count = chunked_softmax_xent(
        hidden, params["embed"].to(torch.bfloat16).t(), batch["targets"],
        batch["mask"], chunk=cfg.vocab_chunk or min(512, S))
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
    return {"m_state": ("layers", "batch", "heads", None, None),
            "m_norm": ("layers", "batch", "heads", None),
            "s_c": ("layers", "batch", "embed"),
            "s_n": ("layers", "batch", "embed"),
            "s_h": ("layers", "batch", "embed"),
            "s_m": ("layers", "batch", "embed"),
            "length": ()}


def _run(params, cfg: ModelConfig, tokens, cache, decode: bool):
    """Every layer over ``tokens`` [B, S] from ``cache`` (None: the zero
    state); returns (last-token logits [B, V] f32, the new state)."""
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    new = {k: [] for k in ("m_state", "m_norm", "s_c", "s_n", "s_h", "s_m")}
    for i, (mp, sp) in enumerate(zip(unstack_layers(params, "m"),
                                     unstack_layers(params, "s"))):
        mstate = ((cache["m_state"][i], cache["m_norm"][i]) if cache
                  else (None, None))
        x, (S_st, n_st) = _mlstm_block(x, mp, state=mstate[0],
                                       norm=mstate[1], decode=decode)
        sstate = ((cache["s_c"][i], cache["s_n"][i], cache["s_h"][i],
                   cache["s_m"][i]) if cache else None)
        x, (c, n, h, m) = _slstm_block(x, sp, state=sstate)
        for key, t in zip(new, (S_st, n_st, c, n, h, m)):
            new[key].append(t)
    hidden = rms_norm(x, params["final_norm"])
    # f32 unembedding with no bf16 round trip of the table
    logits = hidden[:, -1].float() @ params["embed"].float().t()
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
    )
