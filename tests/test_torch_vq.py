"""The VQ image tokenizer of neko_tpu_torch (models/vq.py, envs/vq_wrapper.py,
tools/train_vq.py, examples/world_model.py) against neko_tpu's on the CPU:
neko_tpu's initial variables carried across by
`convert.jax_vq_variables_to_state_dict`, seeded numpy images, fp32.

* encoder output, codes and decoder output at 16x16, 12x20 and the odd
  7x7 and 13x10 (lax's SAME padding: a 7x7 image gives a 2x2 grid), and the
  forward's reconstruction and four metrics where neko_tpu's forward takes
  the size (its reconstruction must match the image: sides of 4k);
* the straight-through gradients of the train-mode loss;
* three train steps against `make_train_step` with `optax.adam`: metrics,
  parameters and the EMA codebook;
* the dead-code restart by its properties (the JAX draw cannot be matched):
  a code whose EMA count falls below 1e-3 takes a row of the batch's
  encodings, with size 1 and `cluster_sum` equal to that row;
* `encode_episode_dataset` and the wrapped env's codes against neko_tpu's,
  and the wrapped env through `ControlTask`;
* `python -m neko_tpu_torch.tools.train_vq --cpu` for a few steps and
  `load_vq`; the world-model walkthrough at a tiny size.

Tolerances (fp32, summation order only): activations and reconstructions
rtol 1e-5, atol 1e-6; metrics rtol 1e-5; gradients rtol 1e-4, atol 1e-7;
after three Adam steps parameters and codebook rtol 1e-4, atol 1e-6.
Codes are compared exactly."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neko_tpu.envs.synthetic import SyntheticImageEnv as JaxImageEnv  # noqa: E402
from neko_tpu.envs.synthetic import collect_expert_dataset as jax_collect  # noqa: E402
from neko_tpu.envs.vq_wrapper import VQImageCodec as JaxCodec  # noqa: E402
from neko_tpu.envs.vq_wrapper import VQObservationWrapper as JaxWrapper  # noqa: E402
from neko_tpu.envs.vq_wrapper import encode_episode_dataset as jax_encode  # noqa: E402
from neko_tpu.models.vq import VQConfig as JaxVQConfig  # noqa: E402
from neko_tpu.models.vq import VQVAE as JaxVQ  # noqa: E402
from neko_tpu.models.vq import make_train_step as jax_train_step  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.envs.spaces import MultiDiscrete  # noqa: E402
from neko_tpu_torch.envs.synthetic import (  # noqa: E402
    SyntheticDiscreteEnv, SyntheticImageEnv, collect_expert_dataset)
from neko_tpu_torch.envs.vq_wrapper import (  # noqa: E402
    VQImageCodec, VQObservationWrapper, encode_episode_dataset)
from neko_tpu_torch.models.vq import VQConfig, VQVAE, adam, make_train_step  # noqa: E402
from neko_tpu_torch.tasks.control import ControlTask  # noqa: E402

CFG = dict(codebook_size=64, code_dim=16, hidden=32)
ACT_TOL = dict(rtol=1e-5, atol=1e-6)
METRIC_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
SIZES = [(16, 16), (12, 20), (7, 7), (13, 10)]


@pytest.fixture(scope="module")
def pair():
    """(neko_tpu's module and variables, the port's VQVAE on their values)."""
    jm = JaxVQ(JaxVQConfig(**CFG))
    var = jax.jit(jm.init)({"params": jax.random.key(0), "codebook": jax.random.key(1)},
                           np.zeros((1, 16, 16, 3), np.float32))
    var = jax.tree_util.tree_map(np.asarray, var)
    return jm, var, _port(var)


def _port(var) -> VQVAE:
    model = VQVAE(VQConfig(**CFG))
    model.load_state_dict(convert.jax_vq_variables_to_state_dict(var["params"], var["codebook"]))
    return model


def _images(B, H, W, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (B, H, W, 3)).astype(np.float32)


def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _jax_tree_as_state_dict(params, codebook=None):
    return {k: v.numpy() for k, v in convert.jax_vq_variables_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, codebook) if codebook is not None
        else {"embedding": np.zeros(1), "cluster_size": np.zeros(1),
              "cluster_sum": np.zeros(1)}).items()}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encoder_codes_decoder_and_forward_match_jax(pair, size):
    jm, var, model = pair
    x = _images(3, *size)
    z_want = np.asarray(jm.apply(var, x, method=lambda m, im: m.encoder(im)))
    z = model.encoder(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    grid = (-(-size[0] // 4), -(-size[1] // 4))
    assert z_want.shape[1:3] == grid and tuple(z.shape) == z_want.shape
    np.testing.assert_allclose(z.detach().numpy(), z_want, **ACT_TOL)
    codes_want = np.asarray(jm.apply(var, x, method=JaxVQ.encode_indices))
    codes = model.encode_indices(torch.from_numpy(x))
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), codes_want)
    dec_want = np.asarray(jm.apply(var, codes_want, grid, method=JaxVQ.decode_indices))
    dec = model.decode_indices(torch.from_numpy(codes_want.copy()), grid).numpy()
    assert dec.shape == dec_want.shape == (3, 4 * grid[0], 4 * grid[1], 3)
    np.testing.assert_allclose(dec, dec_want, **ACT_TOL)
    if size[0] % 4 or size[1] % 4:  # neko_tpu's forward raises: recon and image differ
        return
    recon_want, m_want = jm.apply(var, x)
    recon, m = model(torch.from_numpy(x))
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(recon_want), **ACT_TOL)
    assert set(m) == set(m_want) == {"loss", "recon_mse", "commit", "perplexity"}
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(m_want[k]), err_msg=k, **METRIC_TOL)


def test_straight_through_gradients_match_jax(pair):
    jm, var, _ = pair
    x = _images(4, 16, 16, seed=1)

    codebook = jax.tree_util.tree_map(jnp.asarray, var["codebook"])

    def loss(p):
        (_, m), _ = jm.apply({"params": p, "codebook": codebook}, x, train=True,
                             mutable=["codebook"], rngs={"codebook": jax.random.key(0)})
        return m["loss"]

    want = _jax_tree_as_state_dict(jax.jit(jax.grad(loss))(var["params"]))
    model = _port(var)
    _, m = model(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    m["loss"].backward()
    got = _grads(model)
    assert set(got) == {k for k in want if k not in ("embedding", "cluster_size",
                                                     "cluster_sum")}
    assert np.abs(got["encoder.Conv_0.weight"]).max() > 0  # through the quantizer
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **GRAD_TOL)


def test_three_train_steps_match_make_train_step_with_optax_adam(pair):
    jm, var, _ = pair
    opt = optax.adam(1e-3)
    params, codebook = var["params"], var["codebook"]
    opt_state = opt.init(params)
    jstep = jax_train_step(jm, opt)
    model = _port(var)
    step = make_train_step(model, adam(model, 1e-3))
    g = torch.Generator().manual_seed(0)
    for i in range(3):
        x = _images(8, 16, 16, seed=10 + i)
        params, codebook, opt_state, m_want = jstep(params, codebook, opt_state, x,
                                                    jax.random.key(i))
        m = step(torch.from_numpy(x), g)
        for k in m:
            np.testing.assert_allclose(m[k].item(), float(m_want[k]), err_msg=f"{i} {k}",
                                       **METRIC_TOL)
        want = _jax_tree_as_state_dict(params, codebook)
        for name, t in model.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want[name], err_msg=f"step {i} {name}",
                                       **STEP_TOL)


def test_dead_codes_restart_from_the_batch_encodings(pair):
    _, var, _ = pair
    model = _port(var)
    x = torch.from_numpy(_images(4, 16, 16, seed=2))
    unused = np.setdiff1d(np.arange(64), model.encode_indices(x).numpy())
    dead = torch.from_numpy(unused[[0, len(unused) // 2, -1]])  # codes the batch does not take
    with torch.no_grad():
        model.cluster_size[dead] = 1e-5  # below 1e-3 after the decay
    with torch.no_grad():
        flat = model.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).reshape(-1, 16)
    size_before = model.cluster_size.clone()
    g = torch.Generator().manual_seed(5)
    model(x, train=True, generator=g)
    live = torch.ones(64, dtype=torch.bool)
    live[dead] = False
    assert (model.cluster_size[dead] == 1.0).all()
    for row in dead:
        e = model.embedding[row]
        assert torch.equal(e, model.cluster_sum[row])
        assert (flat - e).abs().amax(dim=1).min() == 0.0, "not a row of the batch's encodings"
    # live codes keep their EMA (no restart): 0.99 of the old count plus the new
    assert torch.all(model.cluster_size[live] >= 0.99 * size_before[live] - 1e-6)
    assert not torch.equal(model.embedding[live], model.cluster_sum[live])
    # another generator, another pick
    again = _port(var)
    with torch.no_grad():
        again.cluster_size[dead] = 1e-5
    again(x, train=True, generator=torch.Generator().manual_seed(6))
    assert not torch.equal(again.embedding[dead], model.embedding[dead])


@pytest.fixture(scope="module")
def codecs(pair):
    jm, var, model = pair
    return JaxCodec(jm, var["params"], var["codebook"]), VQImageCodec(model, "cpu")


def test_episode_dataset_and_wrapped_env_codes_match_jax(codecs):
    jcodec, codec = codecs
    assert codec.grid_for((7, 7)) == jcodec.grid_for((7, 7)) == (2, 2)
    jds = jax_collect(JaxImageEnv(), n_episodes=3, env_id="img")
    ds = collect_expert_dataset(SyntheticImageEnv(), n_episodes=3, env_id="img")
    want, got = jax_encode(jds, jcodec, batch=5), encode_episode_dataset(ds, codec, batch=5)
    assert got.total_episodes == want.total_episodes == 3
    for i in range(3):
        w, e = want.get_episode(i), got.get_episode(i)
        assert e.observations.dtype == np.int64 and e.observations.shape == (17, 16)
        np.testing.assert_array_equal(e.observations, w.observations)
        np.testing.assert_array_equal(e.actions, w.actions)
        np.testing.assert_array_equal(e.rewards, w.rewards)

    jenv, env = JaxWrapper(JaxImageEnv(), jcodec), VQObservationWrapper(SyntheticImageEnv(), codec)
    assert isinstance(env.observation_space, MultiDiscrete)
    assert list(env.observation_space.nvec) == list(jenv.observation_space.nvec) == [64] * 16
    (jo, _), (o, _) = jenv.reset(seed=4), env.reset(seed=4)
    np.testing.assert_array_equal(o, jo)
    for _ in range(3):
        a = env.expert_action(o)
        assert a == jenv.expert_action(jo)
        jo, jr, *_ = jenv.step(a)
        o, r, *_ = env.step(a)
        np.testing.assert_array_equal(o, jo)
        assert r == jr
    from neko_tpu.tasks.control import ControlTask as JaxTask

    jtask = JaxTask("vq-img", jenv, want, context_len=192, seed=0)
    task = ControlTask("vq-img", env, got, context_len=192, seed=0)
    assert task.obs_str == jtask.obs_str == "discrete_obs"
    assert task.observation_tokens == 16 and task.tokens_per_timestep == 18
    rows, jrows = task.sample_batch(2, {}, 192), jtask.sample_batch(2, {}, 192)
    for row, jrow in zip(rows, jrows):
        assert row.keys() == jrow.keys()
        for key in row:
            np.testing.assert_array_equal(row[key], jrow[key], err_msg=key)
    assert rows[0]["discrete_obs"].shape[1] == 16 and (rows[0]["discrete_obs"] < 64).all()
    with pytest.raises(ValueError, match="image observation"):
        VQObservationWrapper(SyntheticDiscreteEnv(), codec)


def test_train_vq_cli_and_load_vq(tmp_path):
    from neko_tpu_torch.tools import train_vq

    out = tmp_path / "vq"
    res = train_vq.main(["--out", str(out), "--cpu", "--steps", "3", "--episodes", "2",
                         "--batch", "4", "--codebook", "32", "--code_dim", "8",
                         "--hidden", "16"])
    assert len(res["recon_mse"]) == 3 and all(np.isfinite(res["recon_mse"]))
    assert json.loads((out / train_vq.CONFIG).read_text())["codebook_size"] == 32
    model = train_vq.load_vq(str(out), "cpu")
    assert not model.training and model.cfg.code_dim == 8
    saved = torch.load(out / train_vq.STATE, weights_only=True)
    for name, t in model.state_dict().items():
        assert torch.equal(t, saved[name]), name


def test_world_model_walkthrough_runs_small():
    from neko_tpu_torch.examples import world_model

    res = world_model.main(["--cpu", "--episodes", "8", "--codebook", "16", "--code_dim", "8",
                            "--hidden", "8", "--vq_steps", "3", "--embed_dim", "32",
                            "--layers", "1", "--heads", "2", "-k", "96", "--batch_size", "4",
                            "--training_steps", "2", "--history", "3", "--dream", "2"])
    assert res["grid"] == (4, 4) and res["steps"] == 2
    assert res["dream"].shape == (2, 16) and (res["dream"] < 16).all()
    assert 0.0 <= res["accuracy"] <= 1.0 and np.isfinite(res["pixel_mse"])
