"""Learning-rate schedules (pure functions of the step scalar), computed in
float32 on the step's device as the JAX package's ``train/schedule.py``
does."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, base_lr: float = 3e-4, warmup: int = 100,
                  total: int = 10_000, min_frac: float = 0.1):
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, base_lr * cos)


def constant(step, *, base_lr: float = 3e-4):
    step = torch.as_tensor(step)
    return torch.full((), base_lr, dtype=torch.float32, device=step.device)
