"""Learning-rate schedules (``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak: float, warmup: int, total: int,
                  floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac * peak`` at ``total``. A float32 0-d tensor on
    ``step``'s device, computed in float32 in the reference's order."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = peak * torch.minimum(torch.ones((), **f32),
                                step / max(warmup, 1))
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(torch.tensor(math.pi, **f32) * t)))
    return torch.where(step < warmup, warm, cos)
