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
    2d steps that end at t (``h0`` is folded into b_0 first)."""
    a = a.clone()
    b = b.clone()
    if h0 is not None:
        b[:, 0] += a[:, 0] * h0
    S = a.shape[1]
    d = 1
    while d < S:
        # compose (a[t-d], b[t-d]) then (a[t], b[t]); the right-hand sides
        # are evaluated before either tensor is written
        b[:, d:], a[:, d:] = (a[:, d:] * b[:, :-d] + b[:, d:],
                              a[:, d:] * a[:, :-d])
        d *= 2
    return b, b[:, -1]
