"""Episode storage (counterpart of neko_tpu/data/episodes.py): the
trajectory store the control tasks sample from, in memory.

The JAX package also reads Minari-layout HDF5 files through h5py and Minari
datasets through `minari`; the port imports neither, and
`H5EpisodeDataset` raises until the HDF5 loader is ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Episode:
    observations: np.ndarray  # [T(+1), ...]; observations/actions may be
    actions: np.ndarray       # dict[str, array] for Dict/Tuple spaces
    rewards: np.ndarray       # [T]

    @property
    def total_timesteps(self) -> int:
        a = self.actions
        if isinstance(a, dict):
            return int(next(iter(a.values())).shape[0])
        return int(a.shape[0])


def component_dict(value):
    """A Tuple space's value as a dict with indexed keys ("0", "1", ...),
    the keys `DictObsCodec` / `DictActCodec` read; a Dict value or an
    array passes through."""
    if isinstance(value, tuple):
        return {str(i): x for i, x in enumerate(value)}
    return value


def stack_steps(values):
    """Per-step values -> [T, ...]: one array, or for Dict / Tuple spaces a
    dict of per-component arrays sharing the leading time dim."""
    values = [component_dict(v) for v in values]
    if isinstance(values[0], dict):
        return {k: np.asarray([v[k] for v in values]) for k in values[0]}
    return np.asarray(values)


def slice_obs(obs, start: int, end: int):
    """observations[start:end], dict-aware (Dict/Tuple spaces store a dict
    of per-component arrays sharing the leading time dim)."""
    if isinstance(obs, dict):
        return {k: v[start:end] for k, v in obs.items()}
    return obs[start:end]


def concat_obs(a, b):
    """Time-axis concatenation, dict-aware."""
    if isinstance(a, dict):
        return {k: np.concatenate([a[k], b[k]], axis=0) for k in a}
    return np.concatenate([a, b], axis=0)


class EpisodeDataset:
    """Base interface; subclasses implement __len__ / get_episode."""

    spec_env_id: Optional[str] = None

    def __len__(self) -> int:
        raise NotImplementedError

    @property
    def total_episodes(self) -> int:
        return len(self)

    def get_episode(self, idx: int) -> Episode:
        raise NotImplementedError

    def get_episodes(self, indices: Sequence[int]) -> List[Episode]:
        return [self.get_episode(int(i)) for i in indices]

    def sample_episodes(
        self,
        n_episodes: int,
        rng: Optional[np.random.Generator] = None,
        episode_indices: Optional[Sequence[int]] = None,
        replace: bool = False,
    ) -> List[Episode]:
        """Uniform sampling without replacement (`rng.choice`, no cursor)."""
        rng = rng or np.random.default_rng()
        if episode_indices is None:
            episode_indices = np.arange(len(self))
        idx = rng.choice(episode_indices, size=n_episodes, replace=replace)
        return self.get_episodes(idx)

    def episode_returns(self) -> np.ndarray:
        return np.array([self.get_episode(i).rewards.sum() for i in range(len(self))])


class InMemoryEpisodeDataset(EpisodeDataset):
    def __init__(self, episodes: List[Episode], spec_env_id: Optional[str] = None):
        self._episodes = episodes
        self.spec_env_id = spec_env_id

    def __len__(self) -> int:
        return len(self._episodes)

    def get_episode(self, idx: int) -> Episode:
        return self._episodes[idx]


class H5EpisodeDataset(EpisodeDataset):
    def __init__(self, path: str):
        raise NotImplementedError(
            f"HDF5 episode file {path!r}: the HDF5 loader needs h5py and is not yet "
            "ported to neko_tpu_torch; use a neko-synth-* dataset")
