"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``;
the paper anneals SL with a cosine).  Each returns the multiplier of the
base rate at ``step`` as a Python float."""

from __future__ import annotations

import math

__all__ = ["cosine_schedule", "linear_warmup_cosine", "exponential_decay"]


def _clip01(t: float) -> float:
    return min(max(t, 0.0), 1.0)


def cosine_schedule(step, total_steps: int, final_frac: float = 0.0) -> float:
    t = _clip01(step / max(total_steps, 1))
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return final_frac + (1.0 - final_frac) * cos


def linear_warmup_cosine(step, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.0) -> float:
    warm = _clip01(step / max(warmup_steps, 1))
    t = _clip01((step - warmup_steps) / max(total_steps - warmup_steps, 1))
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return warm * (final_frac + (1.0 - final_frac) * cos)


def exponential_decay(step, decay: float = 0.99, period: int = 1) -> float:
    """IC/PM schedule: lr ← lr·decay every epoch (paper Appendix E)."""
    return decay ** (step // period)
