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
