"""Learning-rate schedules (constant / linear / cosine with warmup)."""
from __future__ import annotations

import math

import torch


def make_schedule(kind: str, base_lr: float, warmup_steps: int, total_steps: int):
    """step (an int or a 0-d tensor) → the learning rate, a 0-d fp32 tensor
    on the step's device (the CPU for an int)."""
    if kind not in ("constant", "linear", "cosine"):
        raise ValueError(f"unknown schedule {kind!r}")

    def sched(step):
        s = torch.as_tensor(step).float()
        warm = s / max(1.0, warmup_steps)
        frac = torch.clamp((s - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
        if kind == "constant":
            post = torch.ones_like(s)
        elif kind == "linear":
            post = 1.0 - frac
        else:
            post = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * torch.where(s < warmup_steps, warm, post)

    return sched
