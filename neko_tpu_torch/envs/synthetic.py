"""Synthetic control environments + expert datasets (counterpart of
neko_tpu/envs/synthetic.py), on the port's own spaces (envs/spaces.py).

Registered dataset names (usable in --control_datasets):
    neko-synth-continuous-v0     Box(obs 8) / Box(act 2)
    neko-synth-discrete-v0       Box(obs 4) / Discrete(4)
    neko-synth-image-v0          Box(0..255, 16x16 grayscale) / Discrete(3)
    neko-synth-multidiscrete-v0  MultiDiscrete(obs [6,4,8]) / MultiDiscrete(act [4,3])
    neko-synth-text-v0           Text obs / Text action echo task
    neko-synth-dict-v0           Dict obs {image 16x16, state vec} / Discrete(3)
    neko-synth-dictact-v0        MultiDiscrete obs / Dict action
                                 {arm MultiDiscrete([3,3]), gripper Discrete(2)}

Each env draws from `self.np_random`, seeded as gymnasium seeds it, so a
seed gives the JAX package's observations, rewards and expert actions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from neko_tpu_torch.data.episodes import Episode, InMemoryEpisodeDataset, stack_steps
from neko_tpu_torch.envs.spaces import Box, Dict, Discrete, Env, MultiDiscrete, Text


class SyntheticContinuousEnv(Env):
    """Linear dynamics; expert action = tanh(W @ obs).  Reward rises as the
    action approaches the expert's."""

    def __init__(self, obs_dim: int = 8, act_dim: int = 2, horizon: int = 32, seed: int = 0):
        self.observation_space = Box(-np.inf, np.inf, (obs_dim,), np.float32)
        self.action_space = Box(-1.0, 1.0, (act_dim,), np.float32)
        self.horizon = horizon
        rng = np.random.RandomState(seed)
        self._W = (rng.randn(act_dim, obs_dim) / np.sqrt(obs_dim)).astype(np.float32)
        self._A = (np.eye(obs_dim) * 0.9 + 0.05 * rng.randn(obs_dim, obs_dim)).astype(np.float32)
        self._B = (0.3 * rng.randn(obs_dim, act_dim)).astype(np.float32)
        self._t = 0
        self._state = np.zeros(obs_dim, np.float32)

    def expert_action(self, obs: np.ndarray) -> np.ndarray:
        return np.tanh(self._W @ obs).astype(np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._state = self.np_random.standard_normal(
            self.observation_space.shape[0]).astype(np.float32)
        return self._state.copy(), {}

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        reward = float(1.0 - np.abs(action - self.expert_action(self._state)).mean())
        self._state = self._A @ self._state + self._B @ action
        self._t += 1
        return self._state.copy(), reward, False, self._t >= self.horizon, {}


class SyntheticDiscreteEnv(Env):
    """Continuous obs / discrete action; expert = argmax(W @ obs)."""

    def __init__(self, obs_dim: int = 4, n_actions: int = 4, horizon: int = 32, seed: int = 0):
        self.observation_space = Box(-np.inf, np.inf, (obs_dim,), np.float32)
        self.action_space = Discrete(n_actions)
        self.horizon = horizon
        rng = np.random.RandomState(seed)
        self._W = rng.randn(n_actions, obs_dim).astype(np.float32)
        self._A = (np.eye(obs_dim) * 0.9).astype(np.float32)
        self._t = 0
        self._state = np.zeros(obs_dim, np.float32)

    def expert_action(self, obs: np.ndarray) -> int:
        return int(np.argmax(self._W @ obs))

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._state = self.np_random.standard_normal(
            self.observation_space.shape[0]).astype(np.float32)
        return self._state.copy(), {}

    def step(self, action):
        reward = float(int(action) == self.expert_action(self._state))
        self._state = self._A @ self._state + 0.1 * self.np_random.standard_normal(
            self._state.shape[0]).astype(np.float32)
        self._t += 1
        return self._state.copy(), reward, False, self._t >= self.horizon, {}


class SyntheticMultiDiscreteEnv(Env):
    """MultiDiscrete obs AND action.  Expert: component j of the action is a
    fixed affine hash of the observation mod nvec[j]; reward = fraction of
    components matching the expert."""

    def __init__(self, obs_nvec=(6, 4, 8), act_nvec=(4, 3), horizon: int = 32, seed: int = 0):
        self.observation_space = MultiDiscrete(list(obs_nvec))
        self.action_space = MultiDiscrete(list(act_nvec))
        self.horizon = horizon
        rng = np.random.RandomState(seed)
        self._obs_nvec = np.asarray(obs_nvec, np.int64)
        self._act_nvec = np.asarray(act_nvec, np.int64)
        self._W = rng.randint(1, 7, size=(len(act_nvec), len(obs_nvec)))
        self._t = 0
        self._state = np.zeros(len(obs_nvec), np.int64)

    def expert_action(self, obs) -> np.ndarray:
        obs = np.asarray(obs, np.int64)
        return ((self._W @ obs) + np.arange(len(self._act_nvec))) % self._act_nvec

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._state = self.np_random.integers(0, self._obs_nvec).astype(np.int64)
        return self._state.copy(), {}

    def step(self, action):
        want = self.expert_action(self._state)
        reward = float(np.mean(np.asarray(action, np.int64) == want))
        self._state = (
            self._state + 1 + np.asarray(action, np.int64)[: len(self._state)].sum() % 3
        ) % self._obs_nvec
        self._t += 1
        return self._state.copy(), reward, False, self._t >= self.horizon, {}


class SyntheticTextEnv(Env):
    """Text obs AND action, an echo task: the expert action repeats the
    observed word; reward = fraction of character positions matched."""

    def __init__(self, charset: str = "abcde", max_length: int = 4, horizon: int = 16,
                 seed: int = 0):
        self.observation_space = Text(max_length=max_length, min_length=1, charset=charset)
        self.action_space = Text(max_length=max_length, min_length=1, charset=charset)
        self._chars = self.observation_space.characters
        self.max_length = max_length
        self.horizon = horizon
        self._t = 0
        self._word = self._chars[0]

    def _new_word(self) -> str:
        n = int(self.np_random.integers(1, self.max_length + 1))
        return "".join(self._chars[int(i)]
                       for i in self.np_random.integers(0, len(self._chars), size=n))

    def expert_action(self, obs=None) -> str:
        return self._word

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._word = self._new_word()
        return self._word, {}

    def step(self, action):
        action, want = str(action), self._word
        L = max(len(want), len(action), 1)
        reward = sum(1 for a, b in zip(action.ljust(L), want.ljust(L)) if a == b) / L
        self._word = self._new_word()
        self._t += 1
        return self._word, reward, False, self._t >= self.horizon, {}


class SyntheticImageEnv(Env):
    """Grayscale-image obs (HxW uint8); the expert action is encoded in a
    bright bar whose position the policy must read."""

    def __init__(self, size: int = 16, n_actions: int = 3, horizon: int = 16, seed: int = 0):
        self.observation_space = Box(0, 255, (size, size), np.uint8)
        self.action_space = Discrete(n_actions)
        self.size = size
        self.n_actions = n_actions
        self.horizon = horizon
        self._t = 0
        self._target = 0

    def _render_obs(self) -> np.ndarray:
        obs = np.zeros((self.size, self.size), np.uint8)
        band = self.size // self.n_actions
        obs[:, self._target * band : (self._target + 1) * band] = 255
        return obs

    def expert_action(self, obs=None) -> int:
        return self._target

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._target = int(self.np_random.integers(self.n_actions))
        return self._render_obs(), {}

    def step(self, action):
        reward = float(int(action) == self._target)
        self._target = int(self.np_random.integers(self.n_actions))
        self._t += 1
        return self._render_obs(), reward, False, self._t >= self.horizon, {}


class SyntheticDictEnv(Env):
    """Dict observation: camera image + proprioceptive state vector in one
    timestep.  The image shows a bright band at index b, the state's first
    entry carries a shift s in {0, 1}; expert = (b + s) % n_actions."""

    def __init__(self, size: int = 16, n_actions: int = 3, state_dim: int = 4,
                 horizon: int = 16):
        self.observation_space = Dict({
            "image": Box(0, 255, (size, size), np.uint8),
            "state": Box(-np.inf, np.inf, (state_dim,), np.float32),
        })
        self.action_space = Discrete(n_actions)
        self.size = size
        self.n_actions = n_actions
        self.state_dim = state_dim
        self.horizon = horizon
        self._t = 0
        self._band = 0
        self._state = np.zeros(state_dim, np.float32)

    def _obs(self):
        img = np.zeros((self.size, self.size), np.uint8)
        band = self.size // self.n_actions
        img[:, self._band * band : (self._band + 1) * band] = 255
        return {"image": img, "state": self._state.copy()}

    def _randomize(self):
        self._band = int(self.np_random.integers(self.n_actions))
        self._state = self.np_random.standard_normal(self.state_dim).astype(np.float32)

    def expert_action(self, obs=None) -> int:
        shift = 1 if self._state[0] > 0 else 0
        return (self._band + shift) % self.n_actions

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._randomize()
        return self._obs(), {}

    def step(self, action):
        reward = float(int(action) == self.expert_action())
        self._randomize()
        self._t += 1
        return self._obs(), reward, False, self._t >= self.horizon, {}


class SyntheticDictActEnv(Env):
    """Dict ACTION space of discrete components (arm MultiDiscrete([3, 3]),
    gripper Discrete(2)); the expert action is an affine hash of the
    integer obs."""

    def __init__(self, obs_dim: int = 3, horizon: int = 16, seed: int = 0):
        self.observation_space = MultiDiscrete([5] * obs_dim)
        self.action_space = Dict({"arm": MultiDiscrete([3, 3]), "gripper": Discrete(2)})
        self.horizon = horizon
        rng = np.random.RandomState(seed)
        self._W = rng.randint(1, 5, size=(3, obs_dim))
        self._obs_dim = obs_dim
        self._t = 0
        self._state = np.zeros(obs_dim, np.int64)

    def expert_action(self, obs=None):
        h = self._W @ self._state
        return {"arm": np.asarray([h[0] % 3, h[1] % 3], np.int64), "gripper": int(h[2] % 2)}

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        self._t = 0
        self._state = self.np_random.integers(0, 5, self._obs_dim).astype(np.int64)
        return self._state.copy(), {}

    def step(self, action):
        want = self.expert_action()
        hits = float(np.mean(np.asarray(action["arm"]) == want["arm"])) + \
            float(int(action["gripper"]) == want["gripper"])
        self._state = (self._state + 1 + int(action["gripper"])) % 5
        self._t += 1
        return self._state.copy(), hits / 2, False, self._t >= self.horizon, {}


def collect_expert_dataset(
    env: Env,
    n_episodes: int = 32,
    seed: int = 0,
    noise: float = 0.0,
    env_id: Optional[str] = None,
) -> InMemoryEpisodeDataset:
    """Roll the env's built-in expert policy to build an offline dataset
    (episode i is reset with seed + i)."""
    episodes = []
    rng = np.random.RandomState(seed)
    for i in range(n_episodes):
        obs, _ = env.reset(seed=seed + i)
        observations, actions, rewards = [obs], [], []
        done = False
        while not done:
            a = env.expert_action(obs)
            if noise > 0:
                if isinstance(env.action_space, Box):
                    a = np.clip(a + noise * rng.randn(*np.shape(a)), -1, 1).astype(np.float32)
                elif rng.rand() < noise:
                    a = env.action_space.sample()
            obs, r, term, trunc, _ = env.step(a)
            observations.append(obs)
            actions.append(a if isinstance(a, (dict, tuple)) else np.asarray(a))
            rewards.append(r)
            done = term or trunc
        episodes.append(Episode(observations=stack_steps(observations),
                                actions=stack_steps(actions),
                                rewards=np.asarray(rewards, np.float32)))
    return InMemoryEpisodeDataset(episodes, spec_env_id=env_id)


SYNTHETIC_SPECS = {
    "neko-synth-continuous-v0": lambda kw: SyntheticContinuousEnv(**kw),
    "neko-synth-discrete-v0": lambda kw: SyntheticDiscreteEnv(**kw),
    "neko-synth-image-v0": lambda kw: SyntheticImageEnv(**kw),
    "neko-synth-multidiscrete-v0": lambda kw: SyntheticMultiDiscreteEnv(**kw),
    "neko-synth-text-v0": lambda kw: SyntheticTextEnv(**kw),
    "neko-synth-dict-v0": lambda kw: SyntheticDictEnv(**kw),
    "neko-synth-dictact-v0": lambda kw: SyntheticDictActEnv(**kw),
}


def load_synthetic(name: str, load_kwargs: Optional[dict] = None):
    """(env, dataset) pair for a registered synthetic name."""
    load_kwargs = dict(load_kwargs or {})
    n_episodes = load_kwargs.pop("n_episodes", 32)
    seed = load_kwargs.pop("seed", 0)
    load_kwargs.pop("render_mode", None)  # synthetic envs don't render
    env = SYNTHETIC_SPECS[name](load_kwargs)
    dataset = collect_expert_dataset(env, n_episodes=n_episodes, seed=seed, env_id=name)
    return env, dataset
