"""Control task: offline-RL episode sampling + live-env rollout evaluation
(counterpart of neko_tpu/tasks/control.py) for Box, Discrete,
MultiDiscrete, MultiBinary and Text spaces, images included, and Dict /
Tuple spaces of them.

* timestep budget = max_tokens // tokens_per_timestep
* main chunk: the whole episode if it fits (ep_len - 1 steps, the
  reference's asymmetry, kept for distribution parity), else a uniform
  random slice
* prompt types 'start' | 'end' | 'uniform' prepended at
  training_prompt_len_proportion of the budget; share_prompt_episodes=False
  rotates prompts one episode over
* top-k-return episode filter for evaluation prompts
* evaluation: env rollouts with a full-context 'end' prompt, through the
  rollout cache (`Generator.rollout_session`: one ring extend + action
  decode per env step) or the re-pack path (`predict_control` over the
  trimmed window), serial or in lockstep over cloned envs
* Text spaces become one discrete token per character slot (0 = padding);
  Dict / Tuple observations map onto several packer modalities in one
  timestep (`DictObsCodec`), Dict / Tuple actions onto one token run
  (`DictActCodec`)
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from neko_tpu_torch.data.episodes import (
    EpisodeDataset, component_dict, concat_obs, slice_obs)
from neko_tpu_torch.envs import spaces
from neko_tpu_torch.envs.spaces import Box, Discrete, MultiBinary, MultiDiscrete, Text
from neko_tpu_torch.tasks.base import Task

SUPPORTED_SPACES = (Box, Discrete, MultiDiscrete, MultiBinary, Text)
COMPOSITE_SPACES = (spaces.Dict, spaces.Tuple)


def _check_space(space, what: str) -> None:
    if not isinstance(space, SUPPORTED_SPACES + COMPOSITE_SPACES):
        raise NotImplementedError(f"{what} space {space!r} is not supported")


def tokens_per_space(space) -> int:
    if isinstance(space, Box):
        return int(space.shape[0])
    if isinstance(space, Discrete):
        return 1
    if isinstance(space, MultiDiscrete):
        return int(len(space.nvec))
    if isinstance(space, MultiBinary):
        return int(np.prod(space.shape))
    if isinstance(space, Text):
        return int(space.max_length)
    raise NotImplementedError(f"Unsupported space: {space}")


def space_nvec(space):
    """Per-component discrete ranges, or None for non-multi spaces."""
    if isinstance(space, MultiDiscrete):
        return [int(n) for n in np.asarray(space.nvec).reshape(-1)]
    if isinstance(space, MultiBinary):
        return [2] * int(np.prod(space.shape))
    if isinstance(space, Text):
        # one slot per character; index 0 = padding for strings shorter than
        # max_length, 1..len(charset) = space.characters (sorted)
        return [len(space.characters) + 1] * int(space.max_length)
    return None


def encode_text(space: Text, strings) -> np.ndarray:
    """[T] strings -> [T, max_length] int32 (0 = pad, i+1 = characters[i])."""
    index = {c: i + 1 for i, c in enumerate(space.characters)}
    out = np.zeros((len(strings), int(space.max_length)), np.int32)
    for t, s in enumerate(strings):
        for j, ch in enumerate(str(s)[: int(space.max_length)]):
            out[t, j] = index[ch]
    return out


def decode_text(space: Text, indices) -> str:
    """[max_length] component indices -> string (pads stripped, min_length
    enforced with the charset's first character so env.contains holds)."""
    chars = space.characters
    s = "".join(chars[int(i) - 1] for i in np.asarray(indices).reshape(-1) if int(i) > 0)
    if len(s) < int(space.min_length):
        s = s + chars[0] * (int(space.min_length) - len(s))
    return s


def _items(space):
    """(key, subspace) pairs: a Tuple's indexed keys, a Dict's sorted keys."""
    if isinstance(space, spaces.Tuple):
        return [(str(i), s) for i, s in enumerate(space.spaces)]
    return sorted(space.spaces.items())


class ControlImageTransform:
    """Grayscale -> 3 channels, HWC, zero-pad H and W to patch multiples.
    Accepts an env or a Box space."""

    def __init__(self, env, patch_size: int = 16):
        space = getattr(env, "observation_space", env)  # an env or a Box space
        if not isinstance(space, Box) or len(space.shape) not in (2, 3):
            raise ValueError(f"image observations need a 2-D or 3-D Box, got {space!r}")
        self.patch_size = patch_size
        self.grayscale = len(space.shape) == 2
        if self.grayscale:
            self.height, self.width = space.shape
            self.channel_first = False
        else:
            if not (space.shape[0] == 3 or space.shape[-1] == 3):
                raise ValueError(f"colour images need 3 channels, got {space.shape}")
            self.channel_first = space.shape[0] == 3
            if self.channel_first:
                self.height, self.width = space.shape[1], space.shape[2]
            else:
                self.height, self.width = space.shape[0], space.shape[1]
        self.padding_h = (-self.height) % patch_size
        self.padding_w = (-self.width) % patch_size
        self.out_height = self.height + self.padding_h
        self.out_width = self.width + self.padding_w

    def transform(self, images: np.ndarray) -> np.ndarray:
        """[T, ...] -> [T, H', W', 3] float32."""
        images = np.asarray(images, np.float32)
        if self.grayscale:
            images = np.repeat(images.reshape(-1, self.height, self.width, 1), 3, axis=-1)
        elif self.channel_first:
            images = images.transpose(0, 2, 3, 1)
        if self.padding_h or self.padding_w:
            images = np.pad(images, ((0, 0), (0, self.padding_h), (0, self.padding_w), (0, 0)))
        return images


class DictObsCodec:
    """Maps a Dict / Tuple observation space onto the packer's per-timestep
    modality slots in its canonical interleave order [image |
    continuous_obs | discrete_obs]: at most one image Box; all 1-D Boxes
    concatenate (sorted by key) into continuous_obs; Discrete /
    MultiDiscrete / MultiBinary / Text concatenate into discrete_obs."""

    def __init__(self, space, patch_size: int = 16):
        self.image_key = None
        self.image_transform = None
        self.cont_items = []
        self.disc_items = []
        for k, s in _items(space):
            if isinstance(s, Box) and len(s.shape) in (2, 3):
                if self.image_key is not None:
                    raise ValueError("at most one image component per Dict obs space")
                self.image_key = k
                self.image_transform = ControlImageTransform(s, patch_size)
            elif isinstance(s, Box):
                if len(s.shape) != 1:
                    raise ValueError(f"unsupported Box shape {s.shape}")
                self.cont_items.append((k, int(s.shape[0])))
            elif isinstance(s, SUPPORTED_SPACES):
                self.disc_items.append((k, s))
            else:
                raise NotImplementedError(f"unsupported Dict component {s}")
        t = self.image_transform
        self.patches_per_timestep = (
            0 if t is None else (t.out_height // patch_size) * (t.out_width // patch_size))
        self.cont_tokens = sum(n for _, n in self.cont_items)
        self.disc_tokens = sum(tokens_per_space(s) for _, s in self.disc_items)
        self.obs_tokens = self.patches_per_timestep + self.cont_tokens + self.disc_tokens
        self.entry_keys = (["images"] if self.image_key is not None else []) + \
            (["continuous_obs"] if self.cont_items else []) + \
            (["discrete_obs"] if self.disc_items else [])

    def _disc_component(self, s, v, T: int) -> np.ndarray:
        if isinstance(s, Text):
            return encode_text(s, list(v))
        return np.asarray(v, np.int32).reshape(T, -1)

    def encode(self, obs: Dict) -> Dict[str, np.ndarray]:
        """{component key: [T, ...]} -> packer modality entries."""
        T = len(next(iter(obs.values())))
        out: Dict[str, np.ndarray] = {}
        if self.image_key is not None:
            out["images"] = self.image_transform.transform(obs[self.image_key])
        if self.cont_items:
            out["continuous_obs"] = np.concatenate(
                [np.asarray(obs[k], np.float32).reshape(T, -1) for k, _ in self.cont_items],
                axis=1)
        if self.disc_items:
            out["discrete_obs"] = np.concatenate(
                [self._disc_component(s, obs[k], T) for k, s in self.disc_items], axis=1)
        return out


def _obs_tail(h, n: int):
    """history[-n:], dict-aware (slice_obs with a tail window)."""
    return slice_obs(h, -n, None)


class DictActCodec:
    """Maps a Dict / Tuple ACTION space onto one token run per timestep.
    Every component discrete-family (Discrete / MultiDiscrete / MultiBinary
    / Text: the concatenated per-component nvec rides the MultiDiscrete
    decode limits) or every component a 1-D Box (concatenated continuous
    tokens); mixed kinds raise."""

    def __init__(self, space):
        self.is_tuple = isinstance(space, spaces.Tuple)
        items = _items(space)
        kinds = set()
        for _, s in items:
            if isinstance(s, Box):
                if len(s.shape) != 1:
                    raise ValueError(f"unsupported Box action {s.shape}")
                kinds.add("continuous")
            elif isinstance(s, SUPPORTED_SPACES):
                kinds.add("discrete")
            else:
                raise NotImplementedError(f"unsupported Dict component {s}")
        if len(kinds) != 1:
            raise ValueError("Dict action components must all be continuous or all discrete")
        self.kind = kinds.pop()
        self.items = items
        self.widths = [int(s.shape[0]) if isinstance(s, Box) else tokens_per_space(s)
                       for _, s in items]
        self.tokens = sum(self.widths)
        self.nvec = None
        if self.kind == "discrete":
            self.nvec = []
            for _, s in items:
                self.nvec += [int(s.n)] if isinstance(s, Discrete) else space_nvec(s)

    def _enc_component(self, s, v, T: int) -> np.ndarray:
        if isinstance(s, Text):
            return encode_text(s, list(v)).astype(np.float32)
        return np.asarray(v, np.float32).reshape(T, -1)

    def encode(self, actions) -> np.ndarray:
        """{component key: [T, ...]} -> [T, tokens] (int32 / float32)."""
        T = len(next(iter(actions.values())))
        out = np.concatenate([self._enc_component(s, actions[k], T) for k, s in self.items],
                             axis=1)
        return out.astype(np.float32 if self.kind == "continuous" else np.int32)

    def decode(self, vec):
        """[tokens] decoded components -> the Dict (or Tuple) action for
        env.step, each component in its own range and dtype."""
        vec = np.asarray(vec).reshape(-1)
        out, i = {}, 0
        for (k, s), w in zip(self.items, self.widths):
            part = vec[i : i + w]
            i += w
            if isinstance(s, Text):
                out[k] = decode_text(s, part)
            elif isinstance(s, Discrete):
                out[k] = int(part[0])
            else:  # Box / MultiDiscrete / MultiBinary
                out[k] = np.asarray(part, s.dtype).reshape(s.shape)
        if self.is_tuple:
            return tuple(out[str(j)] for j in range(len(self.items)))
        return out


class ControlTask(Task):
    def __init__(
        self,
        env_name: str,
        env,
        dataset: EpisodeDataset,
        context_len: int,
        patch_size: int = 16,
        training_prompt_len_proportion: float = 0.5,
        share_prompt_episodes: bool = True,
        top_k_prompting: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.name = env_name
        self.is_atari = "ALE" in env_name
        self.env = env
        self.dataset = dataset
        self.context_len = context_len
        self.rng = np.random.default_rng(seed)
        # evaluation prompts draw from their own stream (exact resume)
        self.eval_rng = np.random.default_rng(
            None if seed is None else (seed + 0x5EED) % 2**32)

        act_space, obs_space = env.action_space, env.observation_space
        _check_space(act_space, f"{env_name} action")
        _check_space(obs_space, f"{env_name} observation")
        # Text obs become per-character discrete tokens (pad index 0);
        # Dict / Tuple obs map to several packer modalities in one timestep
        self.dict_obs = (DictObsCodec(obs_space, patch_size)
                         if isinstance(obs_space, COMPOSITE_SPACES) else None)
        if self.dict_obs is not None:
            self.obs_str = None
        elif isinstance(obs_space, Box):
            self.obs_str = "images" if len(obs_space.shape) in (2, 3) else "continuous_obs"
        else:
            self.obs_str = "discrete_obs"
        self.image_transform = (
            ControlImageTransform(env, patch_size) if self.obs_str == "images" else None)
        self.text_obs_space = obs_space if isinstance(obs_space, Text) else None
        self.obs_entry_keys = (self.dict_obs.entry_keys if self.dict_obs is not None
                               else [self.obs_str])

        # Dict / Tuple actions: the components concatenate into one token run
        self.dict_act = (DictActCodec(act_space)
                         if isinstance(act_space, COMPOSITE_SPACES) else None)
        self.text_action_space = None
        if self.dict_act is not None:
            self.action_kind = self.dict_act.kind
            self.action_tokens = self.dict_act.tokens
            self.num_actions = None
            self.action_nvec = self.dict_act.nvec
        else:
            self.action_kind = "continuous" if isinstance(act_space, Box) else "discrete"
            self.action_tokens = tokens_per_space(act_space)
            self.num_actions = int(act_space.n) if isinstance(act_space, Discrete) else None
            # MultiDiscrete / MultiBinary / Text: one token per component, each
            # restricted to its own range at decode time
            self.action_nvec = space_nvec(act_space)
            if isinstance(act_space, Text):
                self.text_action_space = act_space
        self.action_str = f"{self.action_kind}_actions"

        if self.dict_obs is not None:
            self.patches_per_timestep = self.dict_obs.patches_per_timestep
            self.observation_tokens = self.dict_obs.obs_tokens
        elif self.obs_str == "images":
            t = self.image_transform
            self.patches_per_timestep = (t.out_height // patch_size) * (t.out_width // patch_size)
            self.observation_tokens = self.patches_per_timestep
        else:
            self.patches_per_timestep = 0
            self.observation_tokens = tokens_per_space(obs_space)

        self.tokens_per_timestep = self.action_tokens + self.observation_tokens + 1
        if context_len < self.tokens_per_timestep:
            raise ValueError(f"context must fit one timestep ({self.tokens_per_timestep}) "
                             f"for env {env_name}")
        if not 0.0 <= training_prompt_len_proportion <= 1.0:
            raise ValueError("training_prompt_len_proportion must lie in [0, 1]")
        self.training_prompt_len_proportion = training_prompt_len_proportion
        self.share_prompt_episodes = share_prompt_episodes
        self.prompt_types = ["start", "end", "uniform"]

        self.top_k_prompting = top_k_prompting
        if top_k_prompting is not None:
            if not 0 < top_k_prompting <= dataset.total_episodes:
                raise ValueError(f"top_k={top_k_prompting} outside (0, "
                                 f"{dataset.total_episodes}]")
            self.top_ids = np.argsort(dataset.episode_returns())[-top_k_prompting:]
        else:
            self.top_ids = None

    @property
    def context_timesteps(self) -> int:
        return self.context_len // self.tokens_per_timestep

    @property
    def required_patches(self) -> int:
        """Static patch budget this task needs in the packer."""
        return self.context_timesteps * self.patches_per_timestep

    def _obs_entries(self, observations) -> Dict[str, np.ndarray]:
        """[T, ...] raw obs (a dict of arrays for Dict / Tuple spaces) ->
        packer modality entries."""
        if self.dict_obs is not None:
            return self.dict_obs.encode(observations)
        if self.image_transform is not None:
            obs = self.image_transform.transform(observations)
        elif self.text_obs_space is not None:
            obs = encode_text(self.text_obs_space, list(observations))
        elif self.obs_str == "discrete_obs":
            obs = np.asarray(observations, np.int32)
        else:
            obs = np.asarray(observations, np.float32)
        return {self.obs_str: obs}

    def _raw_obs_step(self, observation):
        """One env observation -> a [1, ...] raw batch (dict-aware; Tuple obs
        take indexed keys)."""
        observation = component_dict(observation)
        if isinstance(observation, dict):
            return {k: np.asarray(v)[None] for k, v in observation.items()}
        return np.asarray(observation)[None]

    def _act_array(self, actions) -> np.ndarray:
        if self.dict_act is not None:
            return self.dict_act.encode(actions)
        if self.text_action_space is not None:
            return encode_text(self.text_action_space, list(actions))
        a = np.asarray(actions, np.float32 if self.action_kind == "continuous" else np.int32)
        return a.reshape(a.shape[0], self.action_tokens)

    # ------------------------------------------------------------ sampling
    def sample_batch(self, vanilla_batch_size: int, prompted_batch_sizes: Dict[str, int],
                     max_tokens: int = 1024) -> List[Dict]:
        """Expand vanilla + per-prompt-type counts into per-example lists."""
        prompt_proportions: List[float] = [0.0] * vanilla_batch_size
        prompt_types: List[Optional[str]] = [None] * vanilla_batch_size
        for ptype, n in prompted_batch_sizes.items():
            if ptype not in self.prompt_types:
                raise ValueError(f"invalid prompt type {ptype!r}")
            prompt_proportions += [self.training_prompt_len_proportion] * n
            prompt_types += [ptype] * n
        return self.sample_batch_configurable(
            len(prompt_proportions), prompt_proportions, prompt_types,
            max_tokens=max_tokens, share_prompt_episodes=self.share_prompt_episodes)

    def sample_batch_configurable(
        self,
        batch_size: int,
        prompt_proportions: List[float],
        prompt_types: List[Optional[str]],
        max_tokens: int = 1024,
        share_prompt_episodes: bool = True,
        ep_ids: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ) -> List[Dict]:
        rng = self.rng if rng is None else rng
        num_timesteps = max_tokens // self.tokens_per_timestep
        episodes = self.dataset.sample_episodes(batch_size, rng=rng, episode_indices=ep_ids)
        prompt_episodes = episodes if share_prompt_episodes else episodes[1:] + episodes[:1]

        obs_list, act_list, prompt_budget = [], [], []
        for i, ep in enumerate(episodes):
            timesteps_for_main = round(num_timesteps * (1 - prompt_proportions[i]))
            prompt_budget.append(num_timesteps - timesteps_for_main)
            ep_len = ep.total_timesteps
            if timesteps_for_main >= ep_len:
                start, end = 0, ep_len - 1  # the reference keeps ep_len - 1 steps
            else:
                start = int(rng.integers(0, ep_len - timesteps_for_main))
                end = start + timesteps_for_main
            obs_list.append(slice_obs(ep.observations, start, end))
            act_list.append(slice_obs(ep.actions, start, end))

        for i, ep in enumerate(prompt_episodes):
            n_prompt = prompt_budget[i]
            if n_prompt <= 0:
                continue
            ptype = prompt_types[i]
            if ptype not in self.prompt_types:
                raise ValueError(f"invalid prompt type {ptype!r}")
            ep_len = ep.total_timesteps
            if n_prompt >= ep_len:
                p_start, p_end = 0, ep_len - 1
            elif ptype == "start":
                p_start, p_end = 0, n_prompt - 1
            elif ptype == "end":
                p_end = ep_len - 1
                p_start = p_end - n_prompt + 1
            else:  # uniform
                p_start = int(rng.integers(0, ep_len - n_prompt))
                p_end = p_start + n_prompt - 1
            obs_list[i] = concat_obs(slice_obs(ep.observations, p_start, p_end + 1), obs_list[i])
            act_list[i] = concat_obs(slice_obs(ep.actions, p_start, p_end + 1), act_list[i])

        return [{**self._obs_entries(obs), self.action_str: self._act_array(act)}
                for obs, act in zip(obs_list, act_list)]

    # ---------------------------------------------------------- evaluation
    def _clone_env(self):
        """Fresh env for a parallel rollout (a deep copy: its RNG too)."""
        return copy.deepcopy(self.env)

    def _make_session(self, generator):
        return generator.rollout_session(
            obs_str=self.obs_str,
            action_str=self.action_str,
            obs_tokens=self.observation_tokens,
            action_tokens=self.action_tokens,
            action_kind=self.action_kind,
            num_actions=self.num_actions,
            action_nvec=self.action_nvec,
            context_timesteps=generator.cfg.context_len // self.tokens_per_timestep,
            patches_per_timestep=self.patches_per_timestep,
        )

    def _env_action(self, action):
        """Decoded action -> what env.step expects."""
        if self.dict_act is not None:
            return self.dict_act.decode(action)
        if self.action_kind != "discrete":
            return np.asarray(action, np.float32)
        if self.text_action_space is not None:
            return decode_text(self.text_action_space, action)
        if self.action_nvec is not None:
            return np.asarray(action, np.int64)
        return int(action)

    def _sample_eval_prompt(self, generator) -> Dict:
        return self.sample_batch_configurable(
            1, [1.0], ["end"], max_tokens=generator.cfg.context_len,
            share_prompt_episodes=True, ep_ids=self.top_ids,
            rng=self.eval_rng,  # evaluation never perturbs the training stream
        )[0]

    def _metrics(self, returns, clipped_returns, ep_lens) -> Dict[str, float]:
        metrics = {"mean_return": float(np.mean(returns)),
                   "mean_episode_len": float(np.mean(ep_lens))}
        if self.is_atari:
            metrics["mean_clipped_return"] = float(np.mean(clipped_returns))
        return metrics

    def evaluate(
        self,
        generator,
        n_iterations: int = 10,
        deterministic: bool = True,
        promptless_eval: bool = False,
        parallel_episodes: int = 1,
        rollout_cache: bool = True,
    ) -> Dict[str, float]:
        """Env-rollout evaluation.  rollout_cache=True keeps the KV cache
        alive across env steps (`RolloutSession`); False re-packs and
        re-prefills the trimmed window every step."""
        if parallel_episodes > 1:
            clones = [self._clone_env() for _ in range(min(parallel_episodes, n_iterations))]
            return self._evaluate_parallel(generator, n_iterations, deterministic,
                                           promptless_eval, clones, rollout_cache)
        returns, clipped_returns, ep_lens = [], [], []
        ctx_ts = generator.cfg.context_len // self.tokens_per_timestep
        session = self._make_session(generator) if rollout_cache else None
        act_dtype = np.float32 if self.action_kind == "continuous" else np.int32

        for _ in range(n_iterations):
            observation, _ = self.env.reset()
            obs_hist = act_hist = None
            if promptless_eval:
                if session is not None:
                    session.start([None])
            else:
                prompt = self._sample_eval_prompt(generator)
                obs_hist = {k: prompt[k] for k in self.obs_entry_keys}
                act_hist = prompt[self.action_str]
                if session is not None:
                    session.start([prompt])

            done = False
            ep_return = ep_clip = 0.0
            ep_len = 0
            while not done:
                new_obs = self._obs_entries(self._raw_obs_step(observation))
                if session is not None:
                    action = session.step([new_obs], deterministic=deterministic)[0]
                else:
                    new_act = np.zeros((1, self.action_tokens), act_dtype)
                    if obs_hist is None:
                        obs_hist, act_hist = new_obs, new_act
                    else:
                        obs_hist = concat_obs(obs_hist, new_obs)
                        act_hist = np.concatenate([act_hist, new_act], axis=0)
                    obs_hist = _obs_tail(obs_hist, ctx_ts)
                    act_hist = act_hist[-ctx_ts:]
                    action = generator.predict_control(
                        {**obs_hist, self.action_str: act_hist},
                        action_kind=self.action_kind, action_tokens=self.action_tokens,
                        num_actions=self.num_actions, action_nvec=self.action_nvec,
                        deterministic=deterministic)
                    act_hist[-1] = action
                observation, reward, term, trunc, _ = self.env.step(self._env_action(action))
                done = term or trunc
                ep_return += reward
                ep_clip += float(np.clip(reward, -1.0, 1.0))
                ep_len += 1
            returns.append(ep_return)
            clipped_returns.append(ep_clip)
            ep_lens.append(ep_len)
        return self._metrics(returns, clipped_returns, ep_lens)

    def _evaluate_parallel(self, generator, n_iterations: int, deterministic: bool,
                           promptless_eval: bool, clones: List,
                           rollout_cache: bool = True) -> Dict[str, float]:
        """Lockstep rollouts over cloned envs: one batched call serves every
        active episode per env step."""
        ctx_ts = generator.cfg.context_len // self.tokens_per_timestep
        returns, clipped_returns, ep_lens = [], [], []
        remaining = n_iterations
        act_dtype = np.float32 if self.action_kind == "continuous" else np.int32
        session = self._make_session(generator) if rollout_cache else None
        while remaining > 0:
            G = min(len(clones), remaining)
            envs = clones[:G]
            obs, obs_hist, act_hist, prompts = [], [], [], []
            for env in envs:
                obs.append(env.reset()[0])
                if promptless_eval:
                    prompts.append(None)
                    obs_hist.append(None)
                    act_hist.append(None)
                else:
                    prompt = self._sample_eval_prompt(generator)
                    prompts.append(prompt)
                    obs_hist.append({k: prompt[k] for k in self.obs_entry_keys})
                    act_hist.append(prompt[self.action_str])
            if session is not None:
                session.start(prompts)
            done = [False] * G
            ep_ret, ep_clip, ep_len = [0.0] * G, [0.0] * G, [0] * G

            while not all(done):
                if session is not None:
                    # done rows keep stepping on their stale obs (static
                    # batch shape); their actions are ignored below
                    actions = session.step(
                        [self._obs_entries(self._raw_obs_step(obs[i])) for i in range(G)],
                        deterministic=deterministic)
                else:
                    examples = []
                    for i in range(G):
                        if not done[i]:
                            new_obs = self._obs_entries(self._raw_obs_step(obs[i]))
                            new_act = np.zeros((1, self.action_tokens), act_dtype)
                            if obs_hist[i] is None:
                                obs_hist[i], act_hist[i] = new_obs, new_act
                            else:
                                obs_hist[i] = _obs_tail(concat_obs(obs_hist[i], new_obs),
                                                        ctx_ts)
                                act_hist[i] = np.concatenate([act_hist[i], new_act],
                                                             axis=0)[-ctx_ts:]
                        examples.append({**obs_hist[i], self.action_str: act_hist[i]})
                    actions = generator.predict_control_batch(
                        examples, action_kind=self.action_kind,
                        action_tokens=self.action_tokens, num_actions=self.num_actions,
                        action_nvec=self.action_nvec, deterministic=deterministic)
                for i in range(G):
                    if done[i]:
                        continue
                    if session is None:
                        act_hist[i][-1] = actions[i]
                    o, reward, term, trunc, _ = envs[i].step(self._env_action(actions[i]))
                    obs[i] = o
                    done[i] = term or trunc
                    ep_ret[i] += reward
                    ep_clip[i] += float(np.clip(reward, -1.0, 1.0))
                    ep_len[i] += 1
            returns += ep_ret
            clipped_returns += ep_clip
            ep_lens += ep_len
            remaining -= G
        return self._metrics(returns, clipped_returns, ep_lens)
