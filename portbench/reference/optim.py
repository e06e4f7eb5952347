"""The optimizer as the configuration states it, in plain PyTorch: the
gradients clipped to a global norm of `grad_norm_clip` (g * clip / norm
when norm >= clip), then AdamW (decoupled decay p *= 1 - lr * wd, bias-
corrected moments) at the learning rate of the linear-warmup cosine
schedule read at the update count before the update."""

from __future__ import annotations

import math
from typing import Dict

import torch


def schedule(o: dict, step: int) -> float:
    warm = max(int(o["warmup_steps"]), 1)
    base, init = o["learning_rate"], o["init_lr"]
    if step <= warm:
        return init + (base - init) * step / warm
    low = base / o["min_factor"]
    prog = min(max((step - warm) / max(1, o["training_steps"] - warm), 0.0), 1.0)
    return low + 0.5 * (base - low) * (1 + math.cos(math.pi * prog))


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], o: dict):
        self.p, self.o, self.t = params, o, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def clip(self) -> Dict[str, torch.Tensor]:
        """The clipped gradients (what the update reads)."""
        g = {n: p.grad for n, p in self.p.items()}
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
        if norm >= self.o["grad_norm_clip"]:
            g = {n: x * (self.o["grad_norm_clip"] / norm) for n, x in g.items()}
        return g

    @torch.no_grad()
    def step(self, g: Dict[str, torch.Tensor]) -> None:
        o = self.o
        lr, b1, b2 = schedule(o, self.t), o["beta_1"], o["beta_2"]
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n, p in self.p.items():
            p.mul_(1 - lr * o["weight_decay"])
            self.m[n].mul_(b1).add_(g[n], alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
            denom = (self.v[n].sqrt() / math.sqrt(c2)).add_(o["adam_eps"])
            p.addcdiv_(self.m[n], denom, value=-lr / c1)
            p.grad = None
