"""VQ image-tokenized control (counterpart of neko_tpu/envs/vq_wrapper.py):
image observations -> discrete code grids.

Wrapping an image env with `VQObservationWrapper` turns its observation space
into MultiDiscrete([K] * grid cells), so the control task trains on image
codes with one discrete token per grid cell, and a model trained with
--observation_loss predicts the next frame's codes (`Generator.imagine`),
which `VQImageCodec.decode` turns back into an image.

The JAX package subclasses `gymnasium.ObservationWrapper`; the port wraps
its own `envs.spaces.Env` (no gymnasium) and passes `expert_action` through,
so `collect_expert_dataset` and `ControlTask` take a wrapped env unchanged.

Codes must fit the discrete token band: codebook_size <=
ModelConfig.discrete_tokens (the default 1024 holds the default 512).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from neko_tpu_torch.data.episodes import Episode, InMemoryEpisodeDataset
from neko_tpu_torch.envs.spaces import Box, Env, MultiDiscrete
from neko_tpu_torch.models.vq import VQVAE


def _to_float_rgb(obs: np.ndarray) -> np.ndarray:
    """[H, W] or [H, W, C] (uint8 or float) -> float32 [H, W, 3] in [0,1]."""
    x = np.asarray(obs)
    if x.ndim == 2:
        x = np.repeat(x[..., None], 3, axis=-1)
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 255.0
    return x.astype(np.float32)


class VQImageCodec:
    """Encode / decode around a trained VQVAE, which it moves to `device`
    and puts in eval mode."""

    def __init__(self, model: VQVAE, device):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def grid_for(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        d = self.model.cfg.downscale
        return (hw[0] + d - 1) // d, (hw[1] + d - 1) // d

    def encode(self, images: np.ndarray) -> np.ndarray:
        """[B, H, W, 3] float in [0,1] -> int64 [B, h*w] codes."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        return self.model.encode_indices(x).cpu().numpy().astype(np.int64)

    def decode(self, codes: np.ndarray, grid: Tuple[int, int]) -> np.ndarray:
        """int [B, h*w] codes -> float32 [B, 4h, 4w, 3] images."""
        idx = torch.from_numpy(np.asarray(codes, np.int64)).to(self.device)
        return self.model.decode_indices(idx, grid).cpu().numpy()


class VQObservationWrapper(Env):
    """Image obs -> MultiDiscrete code grid (one int per grid cell)."""

    def __init__(self, env: Env, codec: VQImageCodec):
        space = env.observation_space
        if not (isinstance(space, Box) and len(space.shape) in (2, 3)):
            raise ValueError(f"VQ wrapper needs an image observation space, got {space}")
        self.env = env
        self.codec = codec
        self.action_space = env.action_space
        h, w = codec.grid_for(space.shape[:2])
        self.grid = (h, w)
        K = codec.model.cfg.codebook_size
        self.observation_space = MultiDiscrete([K] * (h * w))

    def observation(self, obs) -> np.ndarray:
        return self.codec.encode(_to_float_rgb(obs)[None])[0]

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        return self.observation(obs), reward, term, trunc, info

    @property
    def np_random(self) -> np.random.Generator:
        return self.env.np_random

    def close(self) -> None:
        self.env.close()

    # collect_expert_dataset and the evaluation prompts call the raw env's
    # expert, which reads the env's state, not the observation
    def expert_action(self, obs=None):
        return self.env.expert_action(obs)


def encode_episode_dataset(dataset, codec: VQImageCodec, batch: int = 64,
                           env_id: str = "vq") -> InMemoryEpisodeDataset:
    """Every episode's image observations as VQ code grids ([T, H, W(,C)] ->
    int64 [T, h*w]); actions and rewards untouched.  One batched encode per
    chunk of `batch` frames: the frames are tokenized once, at load."""
    episodes = []
    for i in range(dataset.total_episodes):
        ep = dataset.get_episode(i)
        obs = np.stack([_to_float_rgb(o) for o in np.asarray(ep.observations)])
        codes = [codec.encode(obs[s:s + batch]) for s in range(0, len(obs), batch)]
        episodes.append(Episode(observations=np.concatenate(codes, axis=0),
                                actions=np.asarray(ep.actions),
                                rewards=np.asarray(ep.rewards, np.float32)))
    return InMemoryEpisodeDataset(episodes, spec_env_id=env_id)
