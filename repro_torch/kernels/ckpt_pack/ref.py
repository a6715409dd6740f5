"""Plain PyTorch version of the ckpt_pack chunk gather."""

from __future__ import annotations

import torch


def ckpt_pack_ref(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [N, R, C]; idx [M] (-1 => zeros).  out[i] = src[idx[i]]."""
    idx = idx.to(device=src.device, dtype=torch.long)
    out = src[idx.clamp(min=0)]
    return torch.where((idx >= 0)[:, None, None], out, torch.zeros_like(out))
