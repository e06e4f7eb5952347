"""The rollout cache and generation with targets in neko_tpu_torch against
neko_tpu at converted weights (32d, 1 layer, 2 heads, k = 64, fp32, CPU):

* `NekoModel.extend_step` (the ring append with eviction): logits within
  1e-5, the updated cache mask equal, the written keys and values within
  1e-6, over three extends that evict;
* `RolloutSession` actions over an episode longer than the ring, step by
  step against neko_tpu's `RolloutSession`: the action tokens equal, for
  continuous, discrete, image and MultiDiscrete envs, prompted and not;
* `Generator.generate_batch(targets=)`: the per-token NLLs within 1e-4 and
  the tokens equal, within the context and through the ring.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.envs.synthetic import load_synthetic as jax_load_synthetic  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.tasks.control import ControlTask as JaxControlTask  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.envs.synthetic import load_synthetic  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.tasks.control import ControlTask  # noqa: E402

TINY = dict(embed_dim=32, layers=1, heads=2, context_len=64, max_patches=16,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
NLL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def gens():
    """(neko_tpu Generator, port Generator) over the same weights."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch(
        [{"images": np.zeros((1, 16, 16, 3), np.uint8),
          "discrete_actions": np.zeros((1, 1), np.int32)}])
    arrays.pop("lengths")
    params = jax.jit(jmodel.init)({"params": jax.random.key(5)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return (JaxGenerator(jmodel, params, JaxPacker(jcfg)),
            Generator(convert.build_model(cfg, sd, device="cpu")))


def _jax_layer_cache(cache):
    return cache["transformer"]["h_0"]["attn"]


def test_extend_step_matches_jax_with_eviction(gens):
    jgen, gen = gens
    rng = np.random.default_rng(0)
    B, S, D, K, tpt = 2, TINY["context_len"], TINY["embed_dim"], 5, 7
    L = (S // tpt) * tpt  # the ring: 9 whole timesteps
    lengths = np.array([L, 3 * tpt])  # a full ring and a short one
    emb = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = np.arange(S)[None, :] < lengths[:, None]
    _, jcache = jgen._prefill(jgen.params, jnp.asarray(emb), jnp.asarray(mask))
    with torch.inference_mode():
        _, caches = gen.model.prefill(torch.from_numpy(emb), torch.from_numpy(mask),
                                      last=torch.zeros(B, dtype=torch.long))
    slot = lengths % L
    for _ in range(3):  # each extend evicts the slot it writes into
        chunk = rng.standard_normal((B, K, D)).astype(np.float32)
        want, vars_ = jgen.model.apply(
            {"params": jgen.params, "cache": jcache}, jnp.asarray(chunk),
            jnp.asarray(slot, jnp.int32), jnp.asarray(slot, jnp.int32), tpt, L,
            method=JaxModel.extend_step, mutable=["cache"])
        jcache = vars_["cache"]
        with torch.inference_mode():
            got = gen.model.extend_step(torch.from_numpy(chunk), torch.from_numpy(slot),
                                        torch.from_numpy(slot), tpt, L, caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        jc = _jax_layer_cache(jcache)
        np.testing.assert_array_equal(caches[0]["mask"].numpy(), np.asarray(jc["mask"]))
        for name in ("key", "value"):
            np.testing.assert_allclose(caches[0][name].numpy(), np.asarray(jc[name]),
                                       rtol=1e-6, atol=1e-6)
        # the slot's tail (tpt - K rows) is evicted and not yet rewritten
        assert not caches[0]["mask"][0, slot[0] + K:slot[0] + tpt].any()
        slot = (slot + tpt) % L


ENVS = ["neko-synth-continuous-v0", "neko-synth-discrete-v0", "neko-synth-image-v0",
        "neko-synth-multidiscrete-v0"]


def _tasks(name):
    jenv, jds = jax_load_synthetic(name, {"n_episodes": 8})
    env, ds = load_synthetic(name, {"n_episodes": 8})
    kw = dict(context_len=TINY["context_len"], seed=3)
    return JaxControlTask(name, jenv, jds, **kw), ControlTask(name, env, ds, **kw)


@pytest.mark.parametrize("prompted", [True, False], ids=["prompted", "promptless"])
@pytest.mark.parametrize("name", ENVS)
def test_rollout_session_actions_match_jax_past_the_ring(gens, name, prompted):
    jgen, gen = gens
    jtask, task = _tasks(name)
    jsess, sess = jtask._make_session(jgen), task._make_session(gen)
    assert sess.L == jsess.L and sess.tpt == jsess.tpt
    steps = task.context_timesteps + 3  # the ring wraps
    if prompted:
        jprompt = jtask._sample_eval_prompt(jgen)
        prompt = task._sample_eval_prompt(gen)
        for k in prompt:
            np.testing.assert_array_equal(prompt[k], jprompt[k])
        jsess.start([jprompt])
        sess.start([prompt])
    else:
        jsess.start([None])
        sess.start([None])
    obs, _ = task.env.reset(seed=11)
    for t in range(steps):
        new = task._obs_entries(np.asarray(obs)[None])
        want = jsess.step([new])[0]
        got = sess.step([new])[0]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f"step {t}")
        obs, _, term, trunc, _ = task.env.step(task._env_action(got))
        if term or trunc:
            obs, _ = task.env.reset()


def test_rollout_session_batch_rows_match_jax(gens):
    """Two rows in lockstep (the parallel evaluation's shape)."""
    jgen, gen = gens
    jtask, task = _tasks("neko-synth-continuous-v0")
    jsess, sess = jtask._make_session(jgen), task._make_session(gen)
    prompts = [task._sample_eval_prompt(gen) for _ in range(2)]
    jsess.start(prompts)
    sess.start(prompts)
    rng = np.random.default_rng(4)
    for t in range(2 * task.context_timesteps + 1):
        obs = [{"continuous_obs": rng.standard_normal((1, 8)).astype(np.float32)}
               for _ in range(2)]
        for g, w in zip(sess.step(obs), jsess.step(obs)):
            np.testing.assert_array_equal(g, w, err_msg=f"step {t}")


@pytest.mark.parametrize("lens", [(5, 20, 30), (60, 10, 55)], ids=["fits", "ring"])
def test_generate_batch_target_nll_matches_jax(gens, lens):
    jgen, gen = gens
    rng = np.random.default_rng(7)
    examples = [{"text": rng.integers(0, 256, n)} for n in lens]
    T = 9
    targets = rng.integers(0, 256, (len(lens), T)).astype(np.int32)
    kw = dict(max_new_tokens=T, start=0, end=255, targets=targets, return_logits=False)
    want_t, want_nll = jgen.generate_batch(examples, **kw)
    got_t, got_nll = gen.generate_batch(examples, **kw)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_nll, want_nll, **NLL_TOL)
    # with the logits too: (tokens, logits, nll), the NLL read off the logits
    got = gen.generate_batch(examples, **{**kw, "return_logits": True})
    assert len(got) == 3
    w = got[1]
    logz = np.log(np.exp(w - w.max(-1, keepdims=True)).sum(-1)) + w.max(-1)
    np.testing.assert_allclose(
        got[2], logz - np.take_along_axis(w, targets[..., None], -1)[..., 0], rtol=1e-5,
        atol=1e-5)


def test_predict_control_is_the_batch_of_one(gens):
    jgen, gen = gens
    rng = np.random.default_rng(8)
    ex = {"continuous_obs": rng.standard_normal((3, 8)).astype(np.float32),
          "continuous_actions": np.zeros((3, 2), np.float32)}
    kw = dict(action_kind="continuous", action_tokens=2)
    np.testing.assert_array_equal(gen.predict_control(ex, **kw),
                                  np.asarray(jgen.predict_control(ex, **kw)))
