"""Materialized-mask dropout (counterpart of neko_tpu/ops/dropout.py).

One uint8 draw per element from the step's `torch.Generator`; an element is
kept when its draw is >= q = round(rate * 256), and survivors are scaled by
1 / (1 - q / 256), the REALIZED keep probability, so E[dropout(x)] == x
exactly.  Autograd saves the compact bool keep mask for the backward.  Plain
torch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def keep_threshold(rate: float) -> int:
    """q = round(rate * 256); raises when the rate rounds to dropping all."""
    q = int(round(rate * 256.0))
    if q >= 256:
        raise ValueError(f"dropout rate {rate} rounds to dropping everything")
    return max(q, 0)


def materialized_dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Dropout of `x` at `rate` drawing from `generator`; the identity when
    `generator` is None (deterministic) or the rate rounds to 0."""
    q = keep_threshold(rate)
    if generator is None or q == 0:
        return x
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                         generator=generator)
    return torch.where(bits >= q, x * (1.0 / (1.0 - q / 256.0)), 0)


class Dropout(nn.Module):
    """`materialized_dropout` at a fixed rate."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return materialized_dropout(x, self.rate, generator)
