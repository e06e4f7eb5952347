"""Episode storage (counterpart of neko_tpu/data/episodes.py): the
trajectory store the control tasks sample from, in memory or in a
Minari-layout HDF5 file.

The JAX package reads HDF5 files through h5py; the port reads them with its
own numpy reader (`data/hdf5.py`), which takes what h5py writes by default
and names what it refuses (filters, enums, newer file formats).  Minari
datasets need `minari`, which the port does not import.  The JAX package's
`save_h5` is not ported: nothing on the port's paths writes a file.
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
    """Minari-style HDF5 layout: groups `episode_{i}` with datasets
    observations / actions / rewards (a group of per-component datasets
    for Dict / Tuple spaces), plus attrs `total_episodes` and `env_id` when
    present.  Episodes are read on demand; threads may read at once."""

    def __init__(self, path: str):
        from neko_tpu_torch.data.hdf5 import H5File

        self._file = H5File(path)
        attrs = self._file.attrs
        if "total_episodes" in attrs:
            self._n = int(attrs["total_episodes"])
        else:
            self._n = len([k for k in self._file.keys() if k.startswith("episode_")])
        self.spec_env_id = attrs.get("env_id")

    def __len__(self) -> int:
        return self._n

    def get_episode(self, idx: int) -> Episode:
        from neko_tpu_torch.data.hdf5 import Group

        g = self._file[f"episode_{idx}"]

        def _load(node):  # Dict spaces: one dataset per component key
            if isinstance(node, Group):
                return {k: v.read() for k, v in node.items()}
            return node.read()

        return Episode(observations=_load(g["observations"]), actions=_load(g["actions"]),
                       rewards=g["rewards"].read())

    def close(self):
        self._file.close()
