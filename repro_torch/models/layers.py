"""Shared neural building blocks (PyTorch, mixed precision), the
counterpart of the JAX package's ``models/layers.py``.

``flash_attention_xla`` is the blocked plain-PyTorch path that
``attention_impl="xla_flash"`` selects; the hand-written kernel that
``"pallas"`` selects lives in ``repro_torch.kernels.flash_attention``.
Each function keeps the reference's precision choices (which products
accumulate in f32, where bf16 rounding happens) so the two agree within a
stated tolerance.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distrib.collectives import all_max, gather_along
from repro_torch.distrib.context import DimSplit, cache_split, shard_hint
from repro_torch.distrib.tensor_parallel import reduce_from_group

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------- helpers
def softplus(x):
    # jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus switches to
    # the identity above its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


def unstack_layers(params, prefix: str) -> list[dict[str, torch.Tensor]]:
    """Each layer's slices of the ``prefix/`` stack, keyed without the
    prefix (one ``unbind`` per array, so the backward pass stacks the
    layers' gradients once)."""
    per_key = {k.split("/", 1)[1]: v.unbind(0) for k, v in params.items()
               if k.startswith(prefix + "/")}
    n = len(next(iter(per_key.values())))
    return [{k: v[i] for k, v in per_key.items()} for i in range(n)]


# ------------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dtype)


# -------------------------------------------------------------------- rope
def _rope_freq(half: int, theta: float, device) -> torch.Tensor:
    """f32 ``theta ** (-arange(half) / half)``: the exponent in f32, the
    power in f64 rounded once to f32, which gives XLA's f32 ``pow`` bit for
    bit (``torch.pow`` in f32 is 1 ulp off in a few lanes, an angle error
    that grows with the position)."""
    expo = -torch.arange(0, half, dtype=F32, device=device) / half
    return (theta ** expo.double()).float()


def rope_angles(positions, head_dim: int, theta: float):
    """positions [...]: int -> (sin, cos) of shape [..., head_dim//2]."""
    half = head_dim // 2
    freq = _rope_freq(half, theta, positions.device)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x [..., S, H, hd]; sin/cos [..., S, hd//2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_angles(positions, head_dim: int, theta: float,
                 sections: tuple[int, ...]):
    """Multimodal RoPE (Qwen2-VL): positions [..., 3] (t, h, w); the hd/2
    frequency lanes are split into ``sections`` fed by the three streams,
    in that order.  Returns (sin, cos) of shape [..., head_dim//2]."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"{half} lanes")
    freq = _rope_freq(half, theta, positions.device)
    parts, start = [], 0
    for comp, width in enumerate(sections):
        parts.append(positions[..., comp].float()[..., None]
                     * freq[start:start + width])
        start += width
    ang = torch.cat(parts, dim=-1)
    return torch.sin(ang), torch.cos(ang)


# ------------------------------------------------ blocked (flash) attention
def _softcap(scores, cap: float):
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def flash_attention_xla(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, block_q: int = 512,
                        block_k: int = 1024, q_offset: int = 0):
    """Blocked attention with online softmax.

    q [B, Sq, Hq, hd]; k, v [B, Sk, Hkv, hd]; GQA via head grouping.
    ``window`` > 0 keeps the last ``window`` keys; ``q_offset`` is the
    absolute position of q[0].  Key blocks that are fully masked for a
    query block are skipped, by the reference's (padded-block) test.  As in
    the reference, QK^T accumulates in f32 and P is cast to v's dtype
    before the PV product.  Differentiable: the port's
    ``flash_attention_vjp`` takes its backward from autograd through this
    function, as the reference's does through its own.  The reference's
    hints on the q and k/v blocks place them by kv heads (else by each kv
    head's group); the transformer places its q, k and v so
    (``models/transformer.py::_attention_heads``) before it picks among
    this, the kernel and naive attention, so this gets this process's
    heads.
    """
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    dev = q.device

    qg = q.reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4).float()
    kh = k.permute(0, 2, 1, 3).float()                  # [B, Hkv, Sk, hd]
    vh = v.permute(0, 2, 1, 3)
    blocks = []
    for q0 in range(0, Sq, block_q):
        q1 = min(q0 + block_q, Sq)
        first_q, last_q = q_offset + q0, q_offset + q0 + block_q - 1
        qpos = q_offset + torch.arange(q0, q1, device=dev)
        qi = qg[:, :, :, q0:q1]
        m = torch.full((B, Hkv, G, q1 - q0), -math.inf, dtype=F32, device=dev)
        l = torch.zeros((B, Hkv, G, q1 - q0), dtype=F32, device=dev)
        acc = torch.zeros((B, Hkv, G, q1 - q0, hd), dtype=F32, device=dev)
        for k0 in range(0, Sk, block_k):
            k1 = min(k0 + block_k, Sk)
            last_k = k0 + block_k - 1
            if causal and k0 > last_q:
                continue
            if window > 0 and not last_k > first_q - window:
                continue
            kpos = torch.arange(k0, k1, device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qi, kh[:, :, k0:k1]) * scale
            s = _softcap(s, softcap)
            ok = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                ok &= kpos[None, :] > qpos[:, None] - window
            s = s.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(v.dtype).float(),
                vh[:, :, k0:k1].float())
            m = m_new
        blocks.append((acc / l.clamp_min(1e-30)[..., None]).to(q.dtype))
    # [B, Hkv, G, Sq, hd] -> [B, Sq, Hq, hd]
    out = torch.cat(blocks, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)


def naive_attention(q, k, v, *, causal=True, window: int = 0, softcap=0.0,
                    q_offset: int = 0):
    """Reference O(S²) attention (smoke tests / oracles); ``window`` <= 0
    means full attention."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) / math.sqrt(hd)
    s = _softcap(s, softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)
    return out.reshape(B, Sq, Hq, hd)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int = 0,
                     softcap: float = 0.0, entry: str | None = None):
    """Single-token attention against a cache.

    q [B, 1, Hq, hd]; caches [B, Smax, Hkv, hd]; cache_len: a 0-d or [B]
    tensor — the number of valid cache entries (the new token's k/v already
    inserted).

    ``entry`` names the cache entry the caches are a layer of.  Where the
    installed sharded decode step splits it (``cache_split``), the caches
    are this process's shard: split on the sequence dim, this process
    attends over its own key range (global key positions, so the validity
    mask and the window band are the whole cache's) and the ranges'
    partials are combined by log-sum-exp over the split's group
    (:func:`_combine`); split on the kv-head dim, it attends with its own
    heads' queries and the heads' outputs are gathered.  Otherwise (one
    device, a (1, 1) mesh) this is the plain single-cache softmax.
    """
    seq = heads = None
    if entry is not None:
        seq, heads = cache_split(entry, 2), cache_split(entry, 3)
    B, Smax, Hkv, hd = k_cache.shape
    if seq is None and heads is None:
        Hq = q.shape[2]
        G = Hq // Hkv
        qg = q.reshape(B, Hkv, G, hd)
        s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                         k_cache.float()) / math.sqrt(hd)
        s = _softcap(s, softcap)
        valid = _key_mask(torch.arange(Smax, device=q.device), cache_len,
                          window)
        s = s.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
        return out.reshape(B, 1, Hq, hd)
    if heads is not None:
        G = q.shape[2] // heads.size
        q = q[:, :, heads.start * G:heads.stop * G]
    kpos = torch.arange(Smax, device=q.device) + (seq.start if seq else 0)
    part = _partial_attention(q, k_cache, v_cache, cache_len, kpos,
                              window=window, softcap=softcap)
    out = _combine(part, seq.group if seq else None).to(v_cache.dtype)
    out = out.reshape(B, 1, -1, hd)
    return gather_along(out, heads.group, 2) if heads is not None else out


def _key_mask(kpos, cache_len, window: int):
    """[B or 1, keys]: the keys at (global) positions ``kpos`` that a
    query at position cache_len - 1 sees; the same band as the prefill
    mask."""
    clen = cache_len.reshape(-1, 1)
    valid = kpos[None, :] < clen
    if window > 0:
        valid = valid & (kpos[None, :] > clen - 1 - window)
    return valid


def _partial_attention(q, k, v, cache_len, kpos, *, window: int,
                       softcap: float):
    """One key range's attention partial, all f32 [B, Hkv, G, hd + 2]:
    the row max m, the sum l of exp(s - m) and the unnormalised output
    sum exp(s - m) v.  A range with no visible key has m = NEG_INF, which
    the combine weighs by exp(NEG_INF - max) = 0."""
    B, Sk, Hkv, hd = k.shape
    G = q.shape[2] // Hkv
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, G, hd).float(),
                     k.float()) / math.sqrt(hd)
    s = _softcap(s, softcap)
    s = s.masked_fill(~_key_mask(kpos, cache_len, window)[:, None, None],
                      NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return torch.cat([m[..., None], p.sum(-1)[..., None], o], dim=-1)


def _combine(part, group):
    """Every key range's partial (gathered over ``group``: the only
    exchange over the sequence dim, [B, Hkv, G, hd + 2] per range) merged
    by log-sum-exp: out = sum_i exp(m_i - M) o_i / sum_i exp(m_i - M) l_i,
    M = max_i m_i.  Returns [B, Hkv, G, hd] f32."""
    parts = gather_along(part[None], group, 0)
    m, l, o = parts[..., 0], parts[..., 1], parts[..., 2:]
    w = torch.exp(m - m.amax(0))
    return (o * w[..., None]).sum(0) / (l * w).sum(0)[..., None]


def write_token(cache, new, at, *, entry: str | None = None):
    """Write one token's k or v ``new`` [B, 1, Hkv, hd] IN PLACE into a
    layer of cache ``entry``, ``cache`` [B, Smax, Hkv, hd], at position
    ``at`` (0-d, or [B] per slot).  Where the sharded decode step splits
    the entry (see ``decode_attention``), ``cache`` is this process's shard:
    only the process whose key range holds ``at`` writes (the others write
    back what they hold, so no step waits on a host sync), and each
    writes its own heads."""
    seq = heads = None
    if entry is not None:
        seq, heads = cache_split(entry, 2), cache_split(entry, 3)
    if heads is not None:
        new = new[:, :, heads.start:heads.stop]
    rows = torch.arange(cache.shape[0], device=cache.device)
    if seq is None:
        if at.dim() == 0:
            cache.index_copy_(1, at.reshape(1).long(), new)
        else:
            cache[rows, at.long()] = new[:, 0]
        return
    idx = at.long() - seq.start
    inside = (idx >= 0) & (idx < seq.stop - seq.start)
    idx = idx.clamp(0, seq.stop - seq.start - 1)
    if at.dim() == 0:
        idx = idx.reshape(1)
        cache.index_copy_(1, idx, torch.where(
            inside, new, cache.index_select(1, idx)))
    else:
        cache[rows, idx] = torch.where(inside[:, None, None], new[:, 0],
                                       cache[rows, idx])


# -------------------------------------------------------- chunked CE loss
def chunked_softmax_xent(hidden, embed_t, targets, mask, *, chunk: int = 0,
                         softcap: float = 0.0, vocab: DimSplit | None = None):
    """Cross-entropy over a huge vocab without materialising [B, S, V].

    hidden [B, S, D]; embed_t [D, V]; targets/mask [B, S].  Runs over S in
    chunks; under autograd each chunk is checkpointed, so its f32 logits
    live only inside the chunk (recomputed in the backward pass), as the
    reference's ``jax.checkpoint`` body does.  Returns (sum loss, sum mask).

    ``vocab``: the vocab dim split over the model axis (the reference's hint
    on the logits, ``("batch", None, "vocab")``): ``embed_t`` is this
    process's columns [D, stop - start] of the table, and the log-sum-exp
    is the max and the sum of exponentials over the group, each target's
    logit taken on the process that holds it and summed (the same total on
    every process).  ``hidden`` must come in through ``copy_to_group``.
    """
    B, S, D = hidden.shape
    if not chunk or chunk >= S:
        chunk = S
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(h, t, m):
        logits = _softcap(h.float() @ embed_t.float(), softcap)
        if vocab is None:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, t.long()[..., None])[..., 0]
            return ((lse - picked) * m).sum()
        logits = shard_hint(logits, ("batch", None, "vocab"),
                            (*logits.shape[:2], vocab.size))
        top = all_max(logits.detach().amax(-1), vocab.group)
        lse = torch.log(reduce_from_group(
            torch.exp(logits - top[..., None]).sum(-1), vocab.group)) + top
        idx = t.long() - vocab.start
        inside = (idx >= 0) & (idx < vocab.stop - vocab.start)
        picked = torch.gather(logits, -1, idx.clamp(
            0, vocab.stop - vocab.start - 1)[..., None])[..., 0]
        picked = reduce_from_group(torch.where(inside, picked, 0.0),
                                   vocab.group)
        return ((lse - picked) * m).sum()

    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(n):
        part = slice(i * chunk, (i + 1) * chunk)
        xs = (hidden[:, part], targets[:, part], mask[:, part])
        total = total + (checkpoint(body, *xs, use_reentrant=False)
                         if torch.is_grad_enabled() else body(*xs))
    return total, mask.sum()
