"""Learning-rate schedules: step (a 0-d integer tensor) -> f32 rate,
computed in f32 on the step's device as the JAX package's are."""

from __future__ import annotations

import math
from typing import Callable

import torch

__all__ = ["Schedule", "constant_schedule", "cosine_schedule"]

Schedule = Callable[[torch.Tensor], torch.Tensor]


def constant_schedule(lr: float) -> Schedule:
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(lr, dtype=torch.float32, device=step.device)
    return f


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return f
