"""LR schedule: linear warmup -> cosine decay to min_lr (counterpart of
neko_tpu/training/schedulers.py).

During warmup (step <= warmup_steps) the rate ramps linearly
init_lr -> base_lr; afterwards it decays base_lr -> min_lr along a cosine
over the remaining steps; `cosine_decay=False` holds base_lr after warmup.
Host arithmetic: the optimizer reads a Python float per step, so no device
value is ever fetched.
"""

from __future__ import annotations

import math


def linear_warmup_cosine_decay(
    *,
    base_lr: float,
    init_lr: float,
    min_lr: float,
    warmup_steps: int,
    total_steps: int,
    cosine_decay: bool = True,
):
    """-> schedule(step) -> learning rate (float)."""
    warmup_steps = max(int(warmup_steps), 1)

    def lr(step) -> float:
        step = float(step)
        if step <= warmup_steps:
            return init_lr + (base_lr - init_lr) * step / warmup_steps
        if not cosine_decay:
            return base_lr
        progress = (step - warmup_steps) / max(1, total_steps - warmup_steps)
        progress = min(max(progress, 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * progress))

    return lr
