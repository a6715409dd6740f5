"""Plain PyTorch version of the RG-LRU linear recurrence."""

from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t.  a, b [B, S, W]; h0 [B, W] or None (zeros).
    Returns (h [B, S, W], h_last [B, W]).

    A log-depth doubling scan over time, the associative form of the JAX
    package's oracle: after the step of distance d, (a_t, b_t) composes the
    2d steps that end at t (``h0`` is folded into b_0 first).  Every step
    makes new tensors and writes none it read, so autograd can run through
    it (the yardstick of the kernel's gradient)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    d = 1
    while d < S:
        # compose (a[t-d], b[t-d]) then (a[t], b[t]) for t >= d
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def lru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                     h0: torch.Tensor | None, g: torch.Tensor,
                     g_last: torch.Tensor | None
                     ) -> tuple[torch.Tensor, torch.Tensor,
                                torch.Tensor | None]:
    """The scan's gradient, directly: a reversed loop over time.  a, h
    (the forward's output), g (the gradient reaching h) [B, S, W]; h0 and
    g_last (that reaching h_last) [B, W] or None (zeros).  With
    l_{S-1} = g_{S-1} + g_last and l_t = g_t + a_{t+1} l_{t+1}, returns
    (da, db, dh0): db = l, da_t = l_t h_{t-1} (h_{-1} = h0, or 0) and
    dh0 = a_0 l_0 (None without h0)."""
    S = a.shape[1]
    db = torch.empty_like(g)
    carry = torch.zeros_like(g[:, 0]) if g_last is None else g_last
    coef = torch.ones_like(a[:, 0])
    for t in range(S - 1, -1, -1):
        carry = g[:, t] + coef * carry
        db[:, t] = carry
        coef = a[:, t]
    prev = torch.cat([(torch.zeros_like(h[:, :1]) if h0 is None
                       else h0[:, None]), h[:, :-1]], dim=1)
    return db * prev, db, None if h0 is None else a[:, 0] * db[:, 0]
