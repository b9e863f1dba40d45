"""LR schedules (pure functions of step), in f32 as the reference's."""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1):
    """Linear warmup to `peak_lr`, then cosine decay to min_ratio *
    peak_lr at `total_steps`. Returns a 0-d f32 tensor (on `step`'s
    device when it is a tensor)."""
    step = torch.as_tensor(step).to(F32)
    warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
        math.pi * progress))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
