"""Serving requests for a closed loop, parametrised by a traffic file.

A fixed set of `pool` (prompt length, wanted tokens) pairs, the same for
every seed: prompt lengths at the `pool` quantiles of a lognormal of median
`prompt.median` and sigma `prompt.sigma`, clipped to [prompt.min,
context - want]; wanted tokens uniform over [want.min, want.max], paired
with the lengths by a fixed stride.  The seed orders the set (request k
takes pair order[k % pool]) and draws each prompt's text ids (request k
from SeedSequence([seed, k])): every seed sends the same sizes in another
order."""

from __future__ import annotations

import statistics
from typing import List, Tuple

import numpy as np


def sizes(t: dict, context: int) -> List[Tuple[int, int]]:
    n, p, w = t["pool"], t["prompt"], t["want"]
    nd = statistics.NormalDist()
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        want = w["min"] + int(((i * 7919) % n + 0.5) / n * (w["max"] - w["min"] + 1))
        L = int(round(p["median"] * float(np.exp(p["sigma"] * nd.inv_cdf(u)))))
        out.append((min(max(L, p["min"]), context - want), want))
    return out


class Requests:
    """Request k of a run of seed `seed`: (prompt ids, wanted tokens)."""

    def __init__(self, t: dict, context: int, text_tokens: int, seed: int):
        self.sizes = sizes(t, context)
        self.order = np.random.default_rng([int(seed), 2 ** 31]).permutation(len(self.sizes))
        self.text_tokens, self.seed = text_tokens, int(seed)

    def __call__(self, k: int):
        L, want = self.sizes[self.order[k % len(self.sizes)]]
        ids = np.random.default_rng([self.seed, int(k)]).integers(0, self.text_tokens, L)
        return ids.astype(np.int32), want
