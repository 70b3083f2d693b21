"""Learning-rate schedules as step -> lr callables (port of
``repro/optim/schedules.py``); ``step`` is a 0-d integer tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        step = step.to(torch.float32)
        return lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    return f


def cosine_decay(lr: float, total_steps: int, warmup_steps: int = 0,
                 final_frac: float = 0.1):
    def f(step):
        step = step.to(torch.float32)
        warm = (torch.clamp(step / max(warmup_steps, 1), max=1.0)
                if warmup_steps else 1.0)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                                   * t))
        return lr * warm * cos
    return f
