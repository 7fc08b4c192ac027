"""LR schedules (warmup + cosine) as pure functions of the step."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int = 100, total_steps: int = 10000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32), value)
