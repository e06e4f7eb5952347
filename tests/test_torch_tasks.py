"""The port's synthetic envs, spaces and tasks against neko_tpu's (CPU):

* each synthetic env steps the same observations, rewards and expert
  actions for a seed (envs/spaces.py seeds as gymnasium does), its expert
  dataset is equal array for array, and its spaces match gymnasium's in
  shape, dtype, n and nvec;
* `TextTask.sample_batch` and `ControlTask.sample_batch` (vanilla and every
  prompt type, shared and rotated prompt episodes, top-k prompting) equal
  neko_tpu's bit for bit, and the tasks' host state after them too;
* `TextTask.evaluate` and `ControlTask.evaluate` (serial and lockstep,
  through the rollout cache and the re-pack path), greedy, at converted
  weights (32d, 1 layer, 2 heads, k = 64, fp32): text loss within 1e-4
  relative, control returns and episode lengths within 1e-5;
* the same for the Text, Dict-observation and Dict-action envs
  (`neko-synth-text-v0`, `-dict-v0`, `-dictact-v0`: the Text codecs,
  `DictObsCodec`, `DictActCodec`) through the rollout cache, and the
  re-pack path on the Dict envs.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import gymnasium as gym  # noqa: E402
import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.envs import synthetic as jax_synthetic  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.tasks.control import ControlTask as JaxControlTask  # noqa: E402
from neko_tpu.tasks.text import TextTask as JaxTextTask  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.envs import setup_env, spaces, synthetic  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.tasks.control import ControlTask  # noqa: E402
from neko_tpu_torch.tasks.text import TextTask  # noqa: E402

ENVS = ["neko-synth-continuous-v0", "neko-synth-discrete-v0", "neko-synth-image-v0",
        "neko-synth-multidiscrete-v0"]
# Text, Dict-observation and Dict-action spaces
CODEC_ENVS = ["neko-synth-text-v0", "neko-synth-dict-v0", "neko-synth-dictact-v0"]
TINY = dict(embed_dim=32, layers=1, heads=2, context_len=64, max_patches=16,
            dtype="float32", text_tokens=50257, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are tiny, and in a
    parallel test run the thread pools of the workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space_fields(space):
    out = {"shape": tuple(space.shape), "dtype": np.dtype(space.dtype)}
    for attr in ("n", "nvec", "low", "high"):
        if hasattr(space, attr):
            out[attr] = np.asarray(getattr(space, attr)).tolist()
    return out


@pytest.mark.parametrize("name", ENVS)
def test_synthetic_env_steps_and_spaces_match_gymnasium_env(name):
    jenv, jds = jax_synthetic.load_synthetic(name, {"n_episodes": 6, "seed": 3})
    env, ds = synthetic.load_synthetic(name, {"n_episodes": 6, "seed": 3})
    for j, p in ((jenv.observation_space, env.observation_space),
                 (jenv.action_space, env.action_space)):
        assert type(p).__name__ == type(j).__name__
        assert _space_fields(p) == _space_fields(j)
    assert len(ds) == len(jds) == 6
    for i in range(6):
        a, b = jds.get_episode(i), ds.get_episode(i)
        for f in ("observations", "actions", "rewards"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (i, f)
            np.testing.assert_array_equal(y, x, err_msg=f"episode {i} {f}")
    # reset without a seed keeps the stream (the evaluation resets so)
    for seed in (None, 17):
        o1, o2 = jenv.reset(seed=seed)[0], env.reset(seed=seed)[0]
        np.testing.assert_array_equal(o2, o1)
        for t in range(5):
            act = env.expert_action(o2)
            o1, r1, *_ = jenv.step(act)
            o2, r2, *_ = env.step(act)
            np.testing.assert_array_equal(o2, o1)
            assert r1 == r2


def test_spaces_sample_from_their_seed():
    for space in (spaces.Box(-1.0, 1.0, (3,)), spaces.Box(-np.inf, np.inf, (2,)),
                  spaces.Discrete(5), spaces.MultiDiscrete([4, 3])):
        space.seed(4)
        a = [space.sample() for _ in range(4)]
        space.seed(4)
        b = [space.sample() for _ in range(4)]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    box = spaces.Box(-1.0, 1.0, (3,))
    assert all(((-1 <= box.sample()) & (box.sample() <= 1)).all() for _ in range(10))
    gd = gym.spaces.Discrete(5, seed=9)
    pd = spaces.Discrete(5)
    pd.seed(9)
    assert [int(gd.sample()) for _ in range(8)] == [int(pd.sample()) for _ in range(8)]
    gm = gym.spaces.MultiDiscrete([4, 3], seed=9)
    pm = spaces.MultiDiscrete([4, 3])
    pm.seed(9)
    for _ in range(8):
        np.testing.assert_array_equal(pm.sample(), gm.sample())


def test_unported_names_raise():
    # an HDF5 file reads, but an env id that is no neko-synth-* one needs gymnasium
    h5 = "h5:tests/torch_fixtures/neko-synth-continuous-v0.h5:CartPole-v1"
    for name in ("CartPole-v1", "TOP1_ATARI_TRAIN", h5):
        with pytest.raises(NotImplementedError):
            setup_env.load_env_dataset(name)
    with pytest.raises(NotImplementedError):
        TextTask(["wikitext-2-raw-v1"], ["wikitext"], context_length=64)


def _control_pair(name, **kw):
    jenv, jds = jax_synthetic.load_synthetic(name)
    env, ds = synthetic.load_synthetic(name)
    kw = dict(dict(context_len=64, seed=5), **kw)
    return JaxControlTask(name, jenv, jds, **kw), ControlTask(name, env, ds, **kw)


def _equal_examples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("variant", ["shared", "rotated", "top_k"])
@pytest.mark.parametrize("name", ENVS + CODEC_ENVS)
def test_control_sample_batch_matches_jax(name, variant):
    kw = {"rotated": dict(share_prompt_episodes=False), "top_k": dict(top_k_prompting=5),
          "shared": {}}[variant]
    jtask, task = _control_pair(name, **kw)
    for attr in ("tokens_per_timestep", "observation_tokens", "action_tokens",
                 "patches_per_timestep", "required_patches", "obs_str", "action_str",
                 "num_actions", "action_nvec"):
        assert getattr(task, attr) == getattr(jtask, attr), attr
    for vanilla, prompted in ((3, {}), (1, {"end": 2, "uniform": 1, "start": 1}),
                              (0, {"uniform": 3})):
        _equal_examples(task.sample_batch(vanilla, prompted, max_tokens=64),
                        jtask.sample_batch(vanilla, prompted, max_tokens=64))
    _equal_examples([task._sample_eval_prompt(type("G", (), {"cfg": ModelConfig(**TINY)}))],
                    [jtask._sample_eval_prompt(type("G", (), {"cfg": JaxConfig(**TINY)}))])
    assert pickle.dumps(task.host_state()) == pickle.dumps(jtask.host_state())


def test_text_sample_batch_matches_jax():
    jtask = JaxTextTask(["synthetic"], ["synthetic"], context_length=64, seed=2)
    task = TextTask(["synthetic"], ["synthetic"], context_length=64, seed=2)
    assert task._data == jtask._data
    for n in (1, 5, 8):
        assert task.sample_batch(n) == jtask.sample_batch(n)
        assert task.sample_batch(n, is_test=True, rng=task.eval_rng) == \
            jtask.sample_batch(n, is_test=True, rng=jtask.eval_rng)
    assert pickle.dumps(task.host_state()) == pickle.dumps(jtask.host_state())


@pytest.fixture(scope="module")
def gens():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jax.jit(jmodel.init)({"params": jax.random.key(6)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return (JaxGenerator(jmodel, params, JaxPacker(jcfg)),
            Generator(convert.build_model(cfg, sd, device="cpu")))


def test_text_evaluate_matches_jax(gens):
    jgen, gen = gens
    jtask = JaxTextTask(["synthetic"], ["synthetic"], context_length=64, seed=1)
    task = TextTask(["synthetic"], ["synthetic"], context_length=64, seed=1)
    want = jtask.evaluate(jgen, num_examples_to_test=5)
    got = task.evaluate(gen, num_examples_to_test=5)
    assert set(got) == set(want) == {"loss", "perplexity"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    assert np.isfinite(got["loss"]) and got["loss"] > 0


MODES = {
    "serial-cache": dict(parallel_episodes=1, rollout_cache=True),
    "lockstep-cache": dict(parallel_episodes=2, rollout_cache=True),
    "serial-repack": dict(parallel_episodes=1, rollout_cache=False),
    "lockstep-repack-promptless": dict(parallel_episodes=2, rollout_cache=False,
                                       promptless_eval=True),
}


# the re-pack path on the image env is left out: neko_tpu compiles its
# prefill anew for every history length there (~10 s a case)
@pytest.mark.parametrize("name, mode", [
    ("neko-synth-continuous-v0", m) for m in MODES] + [
    ("neko-synth-image-v0", m) for m in ("serial-cache", "lockstep-cache")] + [
    (name, m) for name in CODEC_ENVS for m in ("serial-cache", "lockstep-cache")] + [
    ("neko-synth-dictact-v0", "serial-repack"),
    ("neko-synth-dict-v0", "lockstep-repack-promptless")])
def test_control_evaluate_matches_jax(gens, name, mode):
    mode = MODES[mode]
    jgen, gen = gens
    jtask, task = _control_pair(name)
    want = jtask.evaluate(jgen, n_iterations=2, deterministic=True, **mode)
    got = task.evaluate(gen, n_iterations=2, deterministic=True, **mode)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
