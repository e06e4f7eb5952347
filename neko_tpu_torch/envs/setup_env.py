"""Dataset name -> (env, dataset) (counterpart of neko_tpu/envs/setup_env.py)
for the synthetic datasets.

The JAX package also expands Atari keywords (TOP1_ATARI_TRAIN/TEST), loads
Minari datasets and ALE envs, and reads HDF5 episode files; each of those
needs a package the port does not import, so any name but a `neko-synth-*`
one raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from neko_tpu_torch.data.episodes import EpisodeDataset
from neko_tpu_torch.envs.synthetic import SYNTHETIC_SPECS, load_synthetic


def expand_dataset_names(dataset_names: List[str]) -> List[str]:
    """The names to load, in order (the port has no keyword lists)."""
    return list(dataset_names)


def load_env_dataset(dataset_name: str,
                     load_kwargs: Optional[Dict] = None) -> Tuple[object, EpisodeDataset]:
    if dataset_name in SYNTHETIC_SPECS:
        return load_synthetic(dataset_name, load_kwargs)
    raise NotImplementedError(
        f"dataset {dataset_name!r} needs Minari or ALE (or h5py for an HDF5 file), which "
        f"neko_tpu_torch does not import; the synthetic ones are {sorted(SYNTHETIC_SPECS)}")


def load_envs(dataset_names: List[str],
              load_kwargs: Optional[Dict] = None) -> Tuple[list, List[EpisodeDataset]]:
    envs, datasets = [], []
    for name in expand_dataset_names(dataset_names):
        env, dataset = load_env_dataset(name, load_kwargs)
        envs.append(env)
        datasets.append(dataset)
    return envs, datasets
