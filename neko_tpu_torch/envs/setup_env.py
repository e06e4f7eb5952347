"""Dataset name -> (env, dataset) (counterpart of neko_tpu/envs/setup_env.py)
for the synthetic datasets and HDF5 episode files.

* `neko-synth-*`: the synthetic env and its expert rollouts;
* `h5:<path>:<EnvId>`, `h5:<path>` or a bare `<path>.h5` / `.hdf5`: the
  episodes of the file (`data/episodes.H5EpisodeDataset`, read without
  h5py) and the env of the id given, else of the file's `env_id`
  attribute.  A `neko-synth-*` id makes the synthetic env; any other id
  raises, since its env needs `gymnasium`, which the port does not import.

The JAX package also expands Atari keywords (TOP1_ATARI_TRAIN/TEST) and
loads Minari datasets and ALE envs; each needs a package the port does not
import, so those names raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from neko_tpu_torch.data.episodes import EpisodeDataset, H5EpisodeDataset
from neko_tpu_torch.envs.synthetic import SYNTHETIC_SPECS, load_synthetic


def expand_dataset_names(dataset_names: List[str]) -> List[str]:
    """The names to load, in order (the port has no keyword lists)."""
    return list(dataset_names)


def _make_env_for_id(env_id: str, load_kwargs: Dict):
    if env_id in SYNTHETIC_SPECS:
        kw = {k: v for k, v in load_kwargs.items()
              if k not in ("n_episodes", "seed", "render_mode")}
        return SYNTHETIC_SPECS[env_id](kw)
    raise NotImplementedError(
        f"env {env_id!r}: making it needs gymnasium (gym.make), which neko_tpu_torch "
        f"does not import; the envs it makes are {sorted(SYNTHETIC_SPECS)}")


def load_env_dataset(dataset_name: str,
                     load_kwargs: Optional[Dict] = None) -> Tuple[object, EpisodeDataset]:
    load_kwargs = load_kwargs or {}
    if dataset_name in SYNTHETIC_SPECS:
        return load_synthetic(dataset_name, load_kwargs)
    if dataset_name.startswith("h5:") or dataset_name.endswith((".h5", ".hdf5")):
        path, env_id = dataset_name, None
        if path.startswith("h5:"):
            parts = path[3:].split(":", 1)
            path = parts[0]
            env_id = parts[1] if len(parts) > 1 else None
        dataset = H5EpisodeDataset(path)
        env_id = env_id or dataset.spec_env_id
        if env_id is None:
            raise ValueError(f"HDF5 dataset {path} carries no env_id attr; use "
                             "'h5:<path>:<EnvId>'")
        return _make_env_for_id(str(env_id), load_kwargs), dataset
    raise NotImplementedError(
        f"dataset {dataset_name!r} needs Minari or ALE, which neko_tpu_torch does not "
        f"import; the synthetic ones are {sorted(SYNTHETIC_SPECS)}, or give an HDF5 "
        "episode file ('h5:<path>:<EnvId>' or a .h5 / .hdf5 path)")


def load_envs(dataset_names: List[str],
              load_kwargs: Optional[Dict] = None) -> Tuple[list, List[EpisodeDataset]]:
    envs, datasets = [], []
    for name in expand_dataset_names(dataset_names):
        env, dataset = load_env_dataset(name, load_kwargs)
        envs.append(env)
        datasets.append(dataset)
    return envs, datasets
