"""Generator in neko_tpu_torch against neko_tpu's Generator at converted
weights (fp32, CPU): greedy tokens identical (including the ring decode past
the context), control predictions identical, the sampling filters equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference import generator as jax_generator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference.generator import (  # noqa: E402
    Generator,
    apply_logit_filters,
)

TINY = dict(embed_dim=64, layers=2, heads=4, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64)


@pytest.fixture(scope="module")
def gens():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(2)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    jgen = jax_generator.Generator(jmodel, params, JaxPacker(jcfg), seed=0)
    return jgen, Generator(convert.build_model(cfg, sd, device="cpu"), seed=0)


TEXT = dict(start=0, end=255)


@pytest.mark.parametrize("case", ["plain", "ring", "inner_pos"])
def test_greedy_tokens_identical(gens, case):
    jgen, gen = gens
    rng = np.random.default_rng(11)
    lens = {"plain": (5, 20, 40), "ring": (60, 10, 55), "inner_pos": (8, 3, 30)}[case]
    examples = [{"text": rng.integers(0, 256, n)} for n in lens]
    kw = dict(max_new_tokens=12, inner_pos_continuation=case == "inner_pos", **TEXT)
    want_t, want_w = jgen.generate_batch(examples, **kw)
    got_t, got_w = gen.generate_batch(examples, **kw)
    if case == "ring":  # 61 + 12 > 64: the decode wraps around the cache
        assert max(lens) + 1 + 12 > TINY["context_len"]
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["continuous", "discrete", "multidiscrete"])
def test_predict_control_batch_identical(gens, kind):
    jgen, gen = gens
    rng = np.random.default_rng(12)
    if kind == "continuous":
        examples = [{"continuous_obs": rng.standard_normal((t, 6)).astype(np.float32),
                     "continuous_actions": np.zeros((t, 3), np.float32)}
                    for t in (2, 4)]
        kw = dict(action_kind="continuous", action_tokens=3)
    elif kind == "discrete":
        examples = [{"images": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                     "discrete_actions": np.zeros((2, 1), np.int32)},
                    {"discrete_obs": rng.integers(0, 64, (3, 2)),
                     "discrete_actions": np.zeros((3, 1), np.int32)}]
        kw = dict(action_kind="discrete", action_tokens=1, num_actions=5)
    else:
        examples = [{"discrete_obs": rng.integers(0, 64, (3, 2)),
                     "discrete_actions": np.zeros((3, 3), np.int32)}]
        kw = dict(action_kind="discrete", action_tokens=3, action_nvec=(3, 5, 2))
    want = jgen.predict_control_batch(examples, **kw)
    got = gen.predict_control_batch(examples, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7), dict(top_k=5), dict(top_p=0.6),
    dict(temperature=1.3, top_k=20, top_p=0.9),
])
def test_logit_filters_match_jax(knobs):
    w = np.random.default_rng(13).standard_normal((4, 64)).astype(np.float32) * 3
    w[1, :8] = w[1, 8]  # ties at the cut keep every tied logit
    want = np.asarray(jax_generator.apply_logit_filters(jnp.asarray(w), **knobs))
    got = apply_logit_filters(torch.from_numpy(w), **knobs).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def test_sampling_is_seeded_and_filtered(gens):
    _, gen = gens
    ex = [{"text": [4, 5, 6]}, {"text": [7] * 12}]
    kw = dict(max_new_tokens=8, deterministic=False, top_k=5, **TEXT)

    def run(seed):
        return gen.generate_batch(ex, generator=torch.Generator().manual_seed(seed), **kw)

    (t1, w1), (t2, _), (t3, _) = run(3), run(3), run(4)
    np.testing.assert_array_equal(t1, t2)
    assert not np.array_equal(t1, t3)
    top5 = np.argsort(-w1, axis=-1)[..., :5]
    assert all(t1[i, s] in top5[i, s] for i in range(2) for s in range(8))
    greedy, _ = gen.generate_batch(ex, max_new_tokens=8, **TEXT)
    one, _ = gen.generate_batch(ex, max_new_tokens=8, deterministic=False, top_k=1, **TEXT)
    np.testing.assert_array_equal(one, greedy)


@pytest.mark.parametrize("bad", [dict(temperature=0.0), dict(top_k=-1), dict(top_p=0.0)])
def test_bad_sampling_args_raise(gens, bad):
    _, gen = gens
    with pytest.raises(ValueError):
        gen.generate_batch([{"text": [1]}], max_new_tokens=2, **bad, **TEXT)


def _history(H=5, seed=21):
    rng = np.random.default_rng(seed)
    hist = {"discrete_obs": np.stack([rng.integers(0, v, H) for v in (6, 4, 8)], 1),
            "discrete_actions": rng.integers(0, 3, (H, 2))}
    return hist, rng.integers(0, 3, (12, 2))


@pytest.mark.parametrize("case", ["discrete", "trimmed", "context_timesteps", "continuous"])
def test_imagine_matches_jax(gens, case):
    """Generator.imagine (neko_tpu's world-model rollout) identical to
    neko_tpu's: per-component ranges, the history re-packed every step and
    trimmed to the context, continuous observations through the mu-law
    bins."""
    jgen, gen = gens
    hist, acts = _history(H=8 if case == "trimmed" else 5)
    kw = dict(obs_nvec=[6, 4, 8])
    if case == "discrete":
        acts = acts[:3]
    elif case == "context_timesteps":
        acts, kw = acts[:4], dict(kw, context_timesteps=3)
    elif case == "continuous":
        rng = np.random.default_rng(5)
        hist = {"continuous_obs": rng.uniform(-1, 1, (4, 3)).astype(np.float32),
                "continuous_actions": rng.uniform(-1, 1, (4, 2)).astype(np.float32)}
        acts, kw = rng.uniform(-1, 1, (2, 2)).astype(np.float32), dict(obs_kind="continuous")
    want = jgen.imagine(hist, acts, **kw)
    got = gen.imagine(hist, acts, **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case != "continuous":
        assert (got < np.asarray([6, 4, 8])).all() and (got >= 0).all()


def test_generate_with_inner_pos_start_matches_jax(gens):
    jgen, gen = gens
    hist, _ = _history()
    ts = gen.cfg.token_space
    kw = dict(max_new_tokens=3, start=ts.start("discrete"), end=ts.start("discrete") + 7,
              step_limits=[6, 4, 8], inner_pos_start=0)
    (want_t, want_w), (got_t, got_w) = jgen.generate(hist, **kw), gen.generate(hist, **kw)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_w, np.asarray(want_w), rtol=1e-4, atol=1e-4)


def test_predict_control_refuses_an_nvec_wider_than_the_discrete_range(gens):
    """neko_tpu's predict_control asserts max(action_nvec) <= the discrete
    range; its batch call (and the port's) does not check."""
    _, gen = gens
    ex = {"discrete_obs": np.asarray([[3], [5]]), "discrete_actions": np.zeros((2, 2), int)}
    kw = dict(action_kind="discrete", action_tokens=2)
    width = TINY["discrete_tokens"]
    got = gen.predict_control(ex, action_nvec=(3, width), **kw)
    assert got.shape == (2,) and (got < (3, width)).all()
    with pytest.raises(ValueError, match="discrete range"):
        gen.predict_control(ex, action_nvec=(3, width + 1), **kw)
    assert len(gen.predict_control_batch([ex], action_nvec=(3, width + 1), **kw)) == 1
