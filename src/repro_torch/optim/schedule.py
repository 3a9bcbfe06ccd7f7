"""Learning-rate schedules (port of ``repro.optim.schedule``): callables
step -> lr as an f32 scalar tensor on the CPU. ``step`` may be a Python
number or a tensor; the math is f32, as in the reference."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return _f32(lr * (final_frac + (1 - final_frac) * cos))
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return f
