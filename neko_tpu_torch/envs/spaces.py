"""The spaces and env base the synthetic envs need, without gymnasium.

`Box`, `Discrete`, `MultiDiscrete`, `MultiBinary`, `Text`, `Dict` and
`Tuple` carry gymnasium's names and the attributes the tasks read (`shape`,
`dtype`, `n`, `nvec`, `low`, `high`, `max_length`, `min_length`,
`characters`, `spaces`), with `seed`, `sample` and `contains`.  Each samples
from its seed exactly as gymnasium's space does; `Dict` / `Tuple` seed
their subspaces from their own stream as gymnasium does, and `Dict` sorts a
mapping's keys as gymnasium does.  `Env.reset(seed=...)` seeds `np_random`
exactly as gymnasium does, `np.random.Generator(PCG64(SeedSequence(seed)))`,
and keeps the stream when called without a seed, so the port's synthetic
envs step the same trajectories as the JAX package's gymnasium envs.
"""

from __future__ import annotations

import string
from typing import Optional, Tuple as TupleT

import numpy as np


def np_random(seed: Optional[int] = None) -> np.random.Generator:
    """gymnasium's `seeding.np_random`: PCG64 over a SeedSequence (fresh
    entropy when seed is None)."""
    if seed is not None and not (isinstance(seed, (int, np.integer)) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int, got {seed!r}")
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        None if seed is None else int(seed))))


class Space:
    def __init__(self, shape: TupleT[int, ...], dtype):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = np.dtype(dtype)
        self._np_random: Optional[np.random.Generator] = None

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random = np_random()
        return self._np_random

    def seed(self, seed: Optional[int] = None):
        self._np_random = np_random(seed)
        return seed


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

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (x.shape == self.shape and bool(np.all(x >= self.low))
                and bool(np.all(x <= self.high)))

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

    def contains(self, x) -> bool:
        return np.ndim(x) == 0 and float(x) == int(x) and \
            self.start <= int(x) < self.start + self.n

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete(Space):
    """Component j in {0, ..., nvec[j] - 1}."""

    def __init__(self, nvec, dtype=np.int64):
        self.nvec = np.asarray(nvec, dtype=dtype)
        super().__init__(self.nvec.shape, dtype)

    def sample(self) -> np.ndarray:
        return (self.np_random.random(self.nvec.shape) * self.nvec).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all((x >= 0) & (x < self.nvec)))

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class MultiBinary(Space):
    """{0, 1}^n (n an int or a shape), int8."""

    def __init__(self, n):
        self.n = int(n) if isinstance(n, (int, np.integer)) else tuple(int(i) for i in n)
        super().__init__((self.n,) if isinstance(self.n, int) else self.n, np.int8)

    def sample(self) -> np.ndarray:
        return self.np_random.integers(low=0, high=2, size=self.n, dtype=self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape and bool(np.all((x == 0) | (x == 1)))

    def __repr__(self) -> str:
        return f"MultiBinary({self.n})"


ALPHANUMERIC = frozenset(string.ascii_letters + string.digits)


class Text(Space):
    """Strings of min_length..max_length characters of `charset`
    (`characters`: the charset sorted, as gymnasium's)."""

    def __init__(self, max_length: int, *, min_length: int = 1, charset=ALPHANUMERIC):
        if not 0 <= int(min_length) <= int(max_length):
            raise ValueError(f"need 0 <= min_length <= max_length, got {min_length}, "
                             f"{max_length}")
        self.min_length, self.max_length = int(min_length), int(max_length)
        self.character_set = frozenset(charset)
        self.character_list = tuple(charset)
        self.characters = "".join(sorted(tuple(charset)))
        super().__init__((), str)
        self.shape = None

    def sample(self) -> str:
        """A uniform length, then uniform characters (gymnasium's draws)."""
        length = self.np_random.integers(self.min_length, self.max_length + 1)
        p = np.ones(len(self.character_set)) / len(self.character_set)
        return "".join(self.np_random.choice(self.character_list, size=length, p=p))

    def contains(self, x) -> bool:
        return (isinstance(x, str) and self.min_length <= len(x) <= self.max_length
                and all(c in self.character_set for c in x))

    def __repr__(self) -> str:
        return f"Text({self.min_length}, {self.max_length}, charset={self.characters})"


def _subseeds(space, n: int):
    """gymnasium's composite seeding: the space's own stream draws one int32
    seed per subspace."""
    return space.np_random.integers(np.iinfo(np.int32).max, size=n)


class Dict(Space):
    """Named subspaces; a mapping's keys are sorted (gymnasium's rule)."""

    def __init__(self, spaces):
        if isinstance(spaces, dict):
            spaces = dict(sorted(spaces.items()))
        self.spaces = dict(spaces)
        super().__init__((), object)
        self.shape = None

    def seed(self, seed=None):
        if seed is None:
            return {k: s.seed(None) for k, s in self.spaces.items()}
        if isinstance(seed, dict):
            return {k: self.spaces[k].seed(seed[k]) for k in seed}
        super().seed(seed)
        return {k: s.seed(int(sub))
                for (k, s), sub in zip(self.spaces.items(), _subseeds(self, len(self.spaces)))}

    def sample(self) -> dict:
        return {k: s.sample() for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return (isinstance(x, dict) and x.keys() == self.spaces.keys()
                and all(self.spaces[k].contains(x[k]) for k in x))

    def __repr__(self) -> str:
        return "Dict(" + ", ".join(f"{k!r}: {s}" for k, s in self.spaces.items()) + ")"


class Tuple(Space):
    """An ordered product of subspaces."""

    def __init__(self, spaces):
        self.spaces = tuple(spaces)
        super().__init__((), object)
        self.shape = None

    def seed(self, seed=None):
        if seed is None:
            return tuple(s.seed(None) for s in self.spaces)
        if isinstance(seed, (tuple, list)):
            return tuple(s.seed(sub) for sub, s in zip(seed, self.spaces))
        super().seed(seed)
        return tuple(s.seed(int(sub))
                     for s, sub in zip(self.spaces, _subseeds(self, len(self.spaces))))

    def sample(self) -> tuple:
        return tuple(s.sample() for s in self.spaces)

    def contains(self, x) -> bool:
        if isinstance(x, (list, np.ndarray)):
            x = tuple(x)
        return (isinstance(x, tuple) and len(x) == len(self.spaces)
                and all(s.contains(v) for s, v in zip(self.spaces, x)))

    def __repr__(self) -> str:
        return "Tuple(" + ", ".join(str(s) for s in self.spaces) + ")"


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
