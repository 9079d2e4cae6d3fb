"""Learning-rate schedules (counterpart of
``neuronx_distributed_tpu/trainer/schedules.py``).

Each is a function of the optimizer's update count, which starts at 0 for
the first update, as optax's schedules are; pass one as the
``learning_rate`` of :func:`.optimizer.make_optimizer`. The formulas are
optax's ``linear_schedule``, ``cosine_decay_schedule`` and
``join_schedules``, written out in Python floats.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


def linear_warmup_linear_decay(peak_lr: float, warmup_steps: int,
                               total_steps: int,
                               end_lr: float = 0.0) -> Schedule:
    """Linear warmup from 0 to ``peak_lr``, then linear decay to
    ``end_lr`` at ``total_steps``."""
    return _join(_linear(0.0, peak_lr, max(warmup_steps, 1)),
                 _linear(peak_lr, end_lr, max(total_steps - warmup_steps, 1)),
                 warmup_steps)


def linear_warmup_cosine_decay(peak_lr: float, warmup_steps: int,
                               total_steps: int,
                               end_lr_ratio: float = 0.1) -> Schedule:
    """Linear warmup from 0 to ``peak_lr``, then cosine decay to
    ``peak_lr * end_lr_ratio`` at ``total_steps`` (optax's
    ``warmup_cosine_decay_schedule``)."""
    end = peak_lr * end_lr_ratio
    alpha = 0.0 if peak_lr == 0.0 else end / peak_lr
    return _join(_linear(0.0, peak_lr, warmup_steps),
                 _cosine(peak_lr, total_steps - warmup_steps, alpha),
                 warmup_steps)
