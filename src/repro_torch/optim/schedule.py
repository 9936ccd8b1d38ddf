"""Learning-rate schedules (step -> lr), the port of the reference's
``optim/schedule.py``.

A schedule takes the optimizer's step count — a Python int or an integer
tensor — and returns the rate as an fp32 tensor, computed in fp32 as the
reference computes it, except the cosine: torch's fp32 ``cos`` is not
correctly rounded (1 ulp off XLA's at 48 of 1247 steps of four schedules),
so it is taken in fp64 and rounded to fp32, which meets XLA's at all but 4
of them.
"""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos((math.pi * t).double()).float())
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = torch.as_tensor(step)
        warm = lr * _f32(step) / max(warmup, 1)
        return torch.where(step < warmup, warm, cos(step - warmup))
    return f
