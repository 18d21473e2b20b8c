"""Learning-rate schedule — the port of ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to 1, then cosine decay to ``min_ratio``, in float32.
    ``step`` is an int or a 0-d tensor; the result is a 0-d float32 tensor on
    ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
