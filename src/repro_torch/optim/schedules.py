"""Learning-rate schedules as step -> lr callables (port of
src/repro/optim/schedules.py; host floats, the step is a host integer)."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def cosine_schedule(peak: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * t))
        return peak * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(
    peak: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
):
    cos = cosine_schedule(peak, max(total_steps - warmup_steps, 1), final_frac)

    def f(step):
        if step < warmup_steps:
            return peak * step / max(warmup_steps, 1)
        return cos(step - warmup_steps)

    return f
