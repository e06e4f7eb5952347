"""The port's Text, MultiBinary, Dict and Tuple spaces against gymnasium's,
and the Text / Dict-observation / Dict-action synthetic envs against
neko_tpu's (CPU):

* from the same seed every space samples what gymnasium's samples (Dict and
  Tuple seed their subspaces from their own stream, nested too), and
  `contains` agrees with gymnasium's on members and non-members;
* `neko-synth-text-v0`, `-dict-v0` and `-dictact-v0` have the same spaces,
  step the same observations and rewards for the same actions, and collect
  the same expert episodes (dict episodes array for array, Tuple values as
  indexed keys).
"""

import numpy as np
import pytest

import gymnasium as gym

from neko_tpu.envs import synthetic as jax_synthetic

from neko_tpu_torch.data.episodes import component_dict, stack_steps
from neko_tpu_torch.envs import spaces, synthetic

CODEC_ENVS = ["neko-synth-text-v0", "neko-synth-dict-v0", "neko-synth-dictact-v0"]

SPACES = {
    "text": lambda m: m.Text(6, min_length=2, charset="zyxab"),
    "text_min0": lambda m: m.Text(3, min_length=0, charset="01"),
    "multibinary": lambda m: m.MultiBinary(7),
    "multibinary_2d": lambda m: m.MultiBinary([2, 3]),
    "dict": lambda m: m.Dict({"state": m.Box(-1.0, 1.0, (3,), np.float32),
                              "image": m.Box(0, 255, (4, 4), np.uint8),
                              "word": m.Text(4, charset="abc")}),
    "tuple": lambda m: m.Tuple([m.Discrete(3), m.MultiBinary(2), m.MultiDiscrete([4, 2])]),
    "nested": lambda m: m.Dict({"b": m.Tuple([m.Discrete(5), m.Text(2, charset="pq")]),
                                "a": m.Dict({"y": m.MultiBinary(3), "x": m.Discrete(2)})}),
}


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("name", SPACES)
def test_space_samples_equal_gymnasium(name):
    want, got = SPACES[name](gym.spaces), SPACES[name](spaces)
    for seed in (0, 11):
        want.seed(seed)
        got.seed(seed)
        for _ in range(6):
            a, b = want.sample(), got.sample()
            _same(a, b)
            assert got.contains(b) and want.contains(a)
    if hasattr(want, "characters"):
        assert got.characters == want.characters
        assert (got.min_length, got.max_length) == (want.min_length, want.max_length)
    if name == "dict":
        assert list(got.spaces) == list(want.spaces) == ["image", "state", "word"]


def test_contains_agrees_with_gymnasium():
    cases = [
        ("text", "zzab", True), ("text", "z", False), ("text", "zzzzzzz", False),
        ("text", "zzq", False), ("text", 12, False),
        ("multibinary", np.array([0, 1, 1, 0, 0, 1, 1], np.int8), True),
        ("multibinary", np.array([0, 2, 1, 0, 0, 1, 1], np.int8), False),
        ("multibinary", np.zeros(6, np.int8), False),
        ("tuple", (np.int64(2), np.array([1, 0], np.int8), np.array([3, 1])), True),
        ("tuple", (np.int64(3), np.array([1, 0], np.int8), np.array([3, 1])), False),
        ("tuple", [np.int64(2), np.array([1, 0], np.int8), np.array([3, 1])], True),
        ("tuple", (np.int64(2), np.array([1, 0], np.int8)), False),
    ]
    for name, x, member in cases:
        want, got = SPACES[name](gym.spaces), SPACES[name](spaces)
        assert bool(want.contains(x)) == member, (name, x)
        assert got.contains(x) == member, (name, x)
    d = SPACES["dict"](spaces)
    d.seed(3)
    x = d.sample()
    assert d.contains(x) and not d.contains({**x, "word": "abcd!"})
    assert not d.contains({k: v for k, v in x.items() if k != "word"})


def test_tuple_values_take_indexed_keys():
    values = [(np.int64(i), np.array([i, 1 - i % 2], np.int8)) for i in range(3)]
    assert list(component_dict(values[0])) == ["0", "1"]
    stacked = stack_steps(values)
    np.testing.assert_array_equal(stacked["0"], [0, 1, 2])
    np.testing.assert_array_equal(stacked["1"], [[0, 1], [1, 0], [2, 1]])
    assert stack_steps(["ab", "c"]).tolist() == ["ab", "c"]


def _space_fields(space):
    out = {"type": type(space).__name__}
    if isinstance(space, (gym.spaces.Dict, spaces.Dict)):
        out["spaces"] = {k: _space_fields(s) for k, s in space.spaces.items()}
        return out
    for attr in ("shape", "n", "nvec", "low", "high", "characters", "min_length",
                 "max_length"):
        if hasattr(space, attr):
            v = getattr(space, attr)
            out[attr] = v if isinstance(v, str) else np.asarray(v).tolist()
    return out


@pytest.mark.parametrize("name", CODEC_ENVS)
def test_codec_env_steps_and_episodes_match_jax(name):
    jenv, jds = jax_synthetic.load_synthetic(name, {"n_episodes": 5, "seed": 2})
    env, ds = synthetic.load_synthetic(name, {"n_episodes": 5, "seed": 2})
    for j, p in ((jenv.observation_space, env.observation_space),
                 (jenv.action_space, env.action_space)):
        assert _space_fields(p) == _space_fields(j)
    assert len(ds) == len(jds) == 5
    for i in range(5):
        a, b = jds.get_episode(i), ds.get_episode(i)
        for f in ("observations", "actions", "rewards"):
            _same(getattr(a, f), getattr(b, f))
    for seed in (None, 9):
        o1, o2 = jenv.reset(seed=seed)[0], env.reset(seed=seed)[0]
        _same(o1, o2)
        assert env.observation_space.contains(o2)
        for _ in range(6):
            act = env.expert_action(o2)
            assert env.action_space.contains(act) and jenv.action_space.contains(act)
            o1, r1, *_ = jenv.step(act)
            o2, r2, *_ = env.step(act)
            _same(o1, o2)
            assert r1 == r2
        wrong = jenv.action_space.sample()  # a non-expert action scores the same
        _, r1, *_ = jenv.step(wrong)
        _, r2, *_ = env.step(wrong)
        assert r1 == r2
