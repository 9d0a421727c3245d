"""LR schedules.

Port of ``distillclip_tpu/training/schedules.py``: HuggingFace's
cosine-with-warmup multiplier stepped once per epoch, so the per-step
learning rate is a function of ``step // steps_per_epoch``.  The arithmetic is
float32, as in the JAX package, so the two give the same rates.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def hf_cosine_with_warmup(base_lr: float, warmup_units: int, total_units: int,
                          num_cycles: float = 0.5) -> Callable[[int], float]:
    """lr(u) = base · u / warmup                       for u < warmup
             = base · max(0, 0.5 (1 + cos(π · 2c · p)))  otherwise,
    with p = (u - warmup) / (total - warmup)."""
    f32 = np.float32

    def schedule(unit) -> float:
        unit = f32(unit)
        warm = max(f32(1.0), f32(warmup_units))
        progress = (unit - f32(warmup_units)) / f32(max(1, total_units - warmup_units))
        cos_val = max(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi * num_cycles * 2.0) * progress, dtype=f32)))
        return float(f32(base_lr) * (unit / warm if unit < warmup_units else cos_val))

    return schedule


def per_epoch(schedule: Callable, steps_per_epoch: int) -> Callable[[int], float]:
    """Wrap an epoch-indexed schedule as a step-indexed one."""

    def step_schedule(step: int) -> float:
        return schedule(step // max(1, steps_per_epoch))

    return step_schedule
