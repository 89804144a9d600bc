"""Learning-rate schedules as ``step -> lr`` functions of an integer step,
after ``repro/optim/schedule.py``.  Computed in float32, as the JAX
package computes them, so the two agree to the last bits."""

from __future__ import annotations

import numpy as np


def constant(lr: float):
    def f(step: int) -> float:
        return float(np.float32(lr))
    return f


def cosine_annealing(lr: float, total_steps: int, final_scale: float = 0.0):
    """SGDR-style cosine from ``lr`` down to ``final_scale * lr``."""
    def f(step: int) -> float:
        t = np.float32(min(step, total_steps)) / np.float32(
            max(total_steps, 1))
        cos = np.float32(0.5) * (np.float32(1.0)
                                 + np.cos(np.float32(np.pi) * t))
        return float(np.float32(lr) * (np.float32(final_scale)
                                       + np.float32(1.0 - final_scale) * cos))
    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_scale: float = 0.1):
    """Linear warmup then cosine decay: the LM-pretraining default."""
    cos = cosine_annealing(lr, max(total_steps - warmup_steps, 1),
                           final_scale)

    def f(step: int) -> float:
        if step < warmup_steps:
            return float(np.float32(lr) * np.float32(step)
                         / np.float32(max(warmup_steps, 1)))
        return cos(step - warmup_steps)
    return f


def exponential_decay(lr: float, decay_steps: int, rate: float = 0.5):
    """``lr * rate ** (step / decay_steps)``."""
    def f(step: int) -> float:
        return float(np.float32(lr) * np.float32(rate) ** (
            np.float32(step) / np.float32(decay_steps)))
    return f
