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

F32 = torch.float32
NEG_INF = -1e30


# ------------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dtype)


# -------------------------------------------------------------------- rope
def rope_angles(positions, head_dim: int, theta: float):
    """positions [...]: int -> (sin, cos) of shape [..., head_dim//2]."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=F32,
                                   device=positions.device) / half)
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
    before the PV product.
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
    out = torch.empty((B, Hkv, G, Sq, hd), dtype=q.dtype, device=dev)
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
        out[:, :, :, q0:q1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    # [B, Hkv, G, Sq, hd] -> [B, Sq, Hq, hd]
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
                     softcap: float = 0.0):
    """Single-token attention against a cache.

    q [B, 1, Hq, hd]; caches [B, Smax, Hkv, hd]; cache_len: a 0-d or [B]
    tensor — the number of valid cache entries (the new token's k/v already
    inserted).
    """
    B, Smax, Hkv, hd = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(),
                     k_cache.float()) / math.sqrt(hd)
    s = _softcap(s, softcap)
    kpos = torch.arange(Smax, device=q.device)
    clen = cache_len.reshape(-1, 1)
    valid = kpos[None, :] < clen
    # query position is clen - 1; same band as the prefill mask
    if window > 0:
        valid = valid & (kpos[None, :] > clen - 1 - window)
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, Hq, hd)
