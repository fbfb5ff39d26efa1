"""Learning-rate schedules (the counterpart of :mod:`repro.optim.schedule`)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int, total: int, floor: float = 0.1):
    """Scale factor in [floor, 1]: linear warmup then cosine decay. A
    float32 0-d tensor (on ``step``'s device when it is a tensor)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(s < warmup, warm, cos)
