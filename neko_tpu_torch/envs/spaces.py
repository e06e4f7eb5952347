"""The spaces and env base the synthetic envs need, without gymnasium.

`Box`, `Discrete` and `MultiDiscrete` carry gymnasium's names and the
attributes the tasks read (`shape`, `dtype`, `n`, `nvec`, `low`, `high`),
with `seed` and `sample`.  `Env.reset(seed=...)` seeds `np_random` exactly
as gymnasium does, `np.random.Generator(PCG64(SeedSequence(seed)))`, and
keeps the stream when called without a seed, so the port's synthetic envs
step the same trajectories as the JAX package's gymnasium envs.
`Text`, `Dict`, `Tuple` and `MultiBinary` are not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """gymnasium's `seeding.np_random`: PCG64 over a SeedSequence (fresh
    entropy when seed is None)."""
    if seed is not None and not (isinstance(seed, (int, np.integer)) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        None if seed is None else int(seed))))


class Space:
    def __init__(self, shape: Tuple[int, ...], dtype):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = np.dtype(dtype)
        self._np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()
        return self._np_random

    def seed(self, seed: Optional[int] = None) -> None:
        self._np_random = np_random(seed)


class Box(Space):
    """A box in R^n; `low` / `high` broadcast to `shape` (±inf allowed)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        super().__init__(shape, dtype)
        self.low = np.full(self.shape, low, dtype=self.dtype) if np.ndim(low) == 0 \
            else np.asarray(low, self.dtype)
        self.high = np.full(self.shape, high, dtype=self.dtype) if np.ndim(high) == 0 \
            else np.asarray(high, self.dtype)

    def sample(self) -> np.ndarray:
        """Uniform on bounded dims, normal on unbounded ones, shifted
        exponential on half-bounded ones (gymnasium's rule)."""
        rng = self.np_random
        high = self.high if self.dtype.kind == "f" else self.high.astype("int64") + 1
        lo_b, hi_b = np.isfinite(self.low), np.isfinite(self.high)
        out = np.empty(self.shape, np.float64)
        unb, low_only = ~lo_b & ~hi_b, lo_b & ~hi_b
        up_only, both = ~lo_b & hi_b, lo_b & hi_b
        out[unb] = rng.normal(size=unb[unb].shape)
        out[low_only] = rng.exponential(size=low_only[low_only].shape) + self.low[low_only]
        out[up_only] = high[up_only] - rng.exponential(size=up_only[up_only].shape)
        out[both] = rng.uniform(self.low[both], high[both], size=both[both].shape)
        if self.dtype.kind in "iu":
            out = np.floor(out)
        return out.astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class Discrete(Space):
    """{start, ..., start + n - 1}."""

    def __init__(self, n: int, start: int = 0):
        super().__init__((), np.int64)
        self.n = int(n)
        self.start = int(start)

    def sample(self) -> np.int64:
        return np.int64(self.start + self.np_random.integers(self.n))

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """Component j in {0, ..., nvec[j] - 1}."""

    def __init__(self, nvec, dtype=np.int64):
        self.nvec = np.asarray(nvec, dtype=dtype)
        super().__init__(self.nvec.shape, dtype)

    def sample(self) -> np.ndarray:
        return (self.np_random.random(self.nvec.shape) * self.nvec).astype(self.dtype)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class Env:
    """gymnasium.Env's seeding contract: `reset(seed=s)` reseeds
    `np_random`, `reset()` keeps its stream; the first use without a seed
    draws fresh entropy."""

    observation_space: Space
    action_space: Space
    spec = None
    _np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()
        return self._np_random

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._np_random = np_random(seed)

    def step(self, action):
        raise NotImplementedError

    def close(self) -> None:
        pass
