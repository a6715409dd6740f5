"""Plain PyTorch versions of the flash attention forward and backward
(O(S^2), f32)."""

from __future__ import annotations

import math

import torch


def _logits(q, k, *, causal, window, softcap, q_offset):
    """(s, t): the masked logits [B, Hkv, G, Sq, Sk] in f32 (masked ones
    -1e30), and tanh(raw / cap) under softcap (else None)."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s / math.sqrt(hd)
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        ok &= kpos[None, :] > qpos[:, None] - window
    return s.masked_fill(~ok, -1e30), t


def attention_lse_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0):
    """``attention_ref``'s output, and each query row's natural-log
    log-sum-exp of its (softcapped, masked) logits, f32 [B, Hq, Sq]."""
    B, Sq, Hq, hd = q.shape
    s, _ = _logits(q, k, causal=causal, window=window, softcap=softcap,
                   q_offset=q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    lse = torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype), lse


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_offset: int = 0):
    """q [B, Sq, Hq, hd]; k, v [B, Sk, Hkv, hd] -> [B, Sq, Hq, hd].

    Everything in f32 (as the Pallas body casts q, k and v before both
    products), then cast to q's dtype."""
    B, Sq, Hq, hd = q.shape
    s, _ = _logits(q, k, causal=causal, window=window, softcap=softcap,
                   q_offset=q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0):
    """dq, dk, dv of ``attention_ref`` for the upstream gradient ``do``,
    the explicit backward in f32: P = exp(s - lse) from the natural-log
    ``lse`` [B, Hq, Sq], D = rowsum(do o), dV = P^T dO, dP = dO V^T,
    dS = P (dP - D), times the softcap's 1 - (s / cap)^2, then
    dQ = dS K scale and dK = dS^T Q scale; the G query heads of a kv head
    sum into its dK and dV.  Returns each in its input's dtype."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    s, t = _logits(q, k, causal=causal, window=window, softcap=softcap,
                   q_offset=q_offset)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Sq, 1).float())
    qg, og, dog = (x.reshape(B, Sq, Hkv, G, hd).float() for x in (q, o, do))
    kf, vf = k.float(), v.float()
    d = torch.einsum("bqhgd,bqhgd->bhgq", dog, og)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - d[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds / math.sqrt(hd)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, Hq, hd)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
