"""The one-device training features of neko_tpu_torch against neko_tpu on the
CPU (fp32, tiny config, weights carried across by convert.py, the
tolerances of tests/test_torch_train.py):

* GEGLU and `gelu_new`: forward logits, loss and every gradient;
* LoRA on `c_attn`: the identity at init, forward and gradients at a
  non-zero `lora_b`, prefill and decode logits;
* `lora_only`: three steps against neko_tpu's `multi_transform`ed chain,
  every frozen parameter bit-unchanged;
* gradient accumulation (k = 2 and 3, with EMA): six calls against
  neko_tpu's `optax.MultiSteps`: losses, parameters, the schedule count,
  the accumulator, the mini-step and the EMA after each call;
* EMA: the closed form, the checkpoint round trip, a checkpoint without
  EMA, a resume that continues it.

Stochastic depth and remat are in tests/test_torch_depth_remat.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.training import train_state as ts  # noqa: E402
from neko_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

from tests.test_torch_train import GRAD_TOL, LOSS_TOL, TINY, _arrays  # noqa: E402

PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
OPT = dict(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2, training_steps=10,
           grad_norm_clip=0.5)


@pytest.fixture(autouse=True, scope="module")
def threefry_keys():
    """neko_tpu's weights drawn with JAX's default PRNG (threefry) in every
    test here: neko_tpu's `cli.build.build_context` sets
    `jax_default_prng_impl` for the whole process (to `--rng_impl`,
    unsafe_rbg by default), so a test file that ran it earlier in the same
    worker would otherwise change the weights every comparison here starts
    from, and with them which elements Adam's normalisation brings nearest
    PARAM_TOL."""
    impl = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", impl)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init_jax(cfg_kw, arrays, seed=2):
    jmodel = JaxModel(JaxConfig(**cfg_kw))
    params = jmodel.init({"params": jax.random.key(seed)}, jax_batch(arrays))["params"]
    return jmodel, params


def _value_and_grad_jax(jmodel, params, arrays, return_logits=False, rngs=None):
    def loss_fn(p):
        logits, loss = jmodel.apply({"params": p}, jax_batch(arrays), deterministic=rngs is None,
                                    compute_loss=True, return_logits=return_logits, rngs=rngs)
        return loss, logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return float(loss), (None if logits is None else np.asarray(logits)), _np(grads)


def _check_grads(model, want_grads, cfg):
    want = convert.jax_grads_to_state_dict(want_grads, cfg)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), err_msg=name, **GRAD_TOL)


def _check_logits(got, want, arrays):
    """Logits of the valid rows (padded rows attend no key: each package
    fills them its own way)."""
    rows = arrays["input_mask"].astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[rows], want[rows], rtol=1e-4, atol=1e-5)


def _port_value_and_grad(cfg, sd, arrays, return_logits=False, generator=None):
    model = convert.build_model(cfg, {k: v.clone() for k, v in sd.items()}, device="cpu")
    logits, loss = model(to_device_batch(arrays, "cpu"), train=generator is not None,
                         compute_loss=True, return_logits=return_logits, generator=generator)
    loss.backward()
    return model, loss, logits


# ------------------------------------------------------------- activations
@pytest.mark.parametrize("act", ["geglu", "gelu_new"])
def test_activation_forward_and_grads_match_jax(act):
    kw = dict(TINY, activation_fn=act)
    arrays = _arrays()
    jmodel, params = _init_jax(kw, arrays)
    want_loss, want_logits, want_grads = _value_and_grad_jax(jmodel, params, arrays, True)
    cfg = ModelConfig(**kw)
    sd = convert.jax_params_to_state_dict(_np(params), cfg)
    assert ("transformer.h.0.mlp.gate.weight" in sd) == (act == "geglu")
    model, loss, logits = _port_value_and_grad(cfg, sd, arrays, return_logits=True)
    _check_logits(logits, want_logits, arrays)
    np.testing.assert_allclose(loss.item(), want_loss, **LOSS_TOL)
    _check_grads(model, want_grads, cfg)
    # round trip of the new leaves
    back = convert.state_dict_to_jax_params(sd, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(_np(params))):
        np.testing.assert_array_equal(a, b)


def test_gelu_tanh_is_jax_approximate_gelu():
    from neko_tpu_torch.ops.gelu import gelu_tanh

    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 4
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    np.testing.assert_allclose(gelu_tanh(torch.from_numpy(x)).numpy(), want, rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------------------- LoRA
LORA = dict(TINY, lora_r=4, lora_alpha=8, lora_dropout=0.0)


@pytest.fixture(scope="module")
def lora_pair():
    """(jax model, jax params with a non-zero lora_b, port cfg, state dict)."""
    arrays = _arrays()
    jmodel, params = _init_jax(LORA, arrays)
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.05)
                      if "lora_b" in jax.tree_util.keystr(p) else v), params)
    cfg = ModelConfig(**LORA)
    return jmodel, params, cfg, convert.jax_params_to_state_dict(_np(params), cfg)


def test_lora_is_the_identity_at_init():
    cfg = ModelConfig(**LORA)
    sd = convert.init_state_dict(cfg, 0)
    assert all((v == 0).all() for k, v in sd.items() if "lora_b" in k)
    a = sd["transformer.h.0.attn.lora_a.weight"]
    bound = np.sqrt(6.0 / cfg.embed_dim)
    assert a.abs().max() <= bound and a.abs().max() > 0.5 * bound  # he-uniform
    plain_cfg = ModelConfig(**TINY)
    plain = {k: v for k, v in sd.items() if "lora" not in k}
    batch = to_device_batch(_arrays(), "cpu")
    with torch.no_grad():
        got = convert.build_model(cfg, sd, "cpu")(batch, return_logits=True)[0]
        want = convert.build_model(plain_cfg, plain, "cpu")(batch, return_logits=True)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_lora_forward_and_grads_match_jax(lora_pair):
    jmodel, params, cfg, sd = lora_pair
    back = convert.state_dict_to_jax_params(sd, cfg)  # lora_a / lora_b both ways
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(_np(params))):
        np.testing.assert_array_equal(a, b)
    arrays = _arrays()
    want_loss, want_logits, want_grads = _value_and_grad_jax(jmodel, params, arrays, True)
    model, loss, logits = _port_value_and_grad(cfg, sd, arrays, return_logits=True)
    _check_logits(logits, want_logits, arrays)
    np.testing.assert_allclose(loss.item(), want_loss, **LOSS_TOL)
    _check_grads(model, want_grads, cfg)


def test_lora_prefill_and_decode_match_jax(lora_pair):
    from tests.test_torch_model import _jax_prefill

    jmodel, params, cfg, sd = lora_pair
    model = convert.build_model(cfg, sd, device="cpu")
    arrays = _arrays(images=False)
    emb = np.array(jmodel.apply({"params": params}, jax_batch(arrays),
                                method=JaxModel.embed_batch))
    mask = arrays["input_mask"]
    want, jcache = _jax_prefill(jmodel, params, emb, mask)
    with torch.no_grad():
        got, caches = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    rows = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=1e-4, atol=1e-4)
    pos = mask.sum(1).astype(np.int32)
    tok = np.random.default_rng(3).integers(0, 256, (mask.shape[0], 1)).astype(np.int32)
    e = np.array(jmodel.apply({"params": params}, jnp.asarray(tok), method=JaxModel.embed_tokens))
    want_d, _ = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(e),
                             jnp.asarray(pos), method=JaxModel.decode_step, mutable=["cache"])
    with torch.no_grad():
        got_d = model.decode_step(model.embed_tokens(torch.from_numpy(tok)),
                                  torch.from_numpy(pos), caches)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ JAX train contexts
def _jax_context(cfg_kw, opt_kw, arrays):
    from neko_tpu.parallel import sharding as shd
    from neko_tpu.parallel.mesh import create_mesh
    from neko_tpu.training.train_state import OptimizerConfig as JaxOpt
    from neko_tpu.training.train_state import TrainContext as JaxContext

    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    jctx = JaxContext(JaxConfig(**cfg_kw), JaxOpt(**opt_kw), mesh, seed=0)
    jbatch = shd.shard_batch(mesh, jax_batch(arrays))
    return jctx, jctx.init_state(jbatch), jbatch


def _counts(opt_state):
    """Every `count` leaf of an optax state (the schedule's among them)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        if jax.tree_util.keystr(path).endswith(".count"):
            out.append(int(leaf))
    return out


def test_lora_only_three_steps_match_jax():
    cfg_kw = dict(LORA, lora_dropout=0.0)
    opt = dict(OPT, lora_only=True)
    arrays = _arrays(images=False, target_budget=128)
    jctx, jstate, jbatch = _jax_context(cfg_kw, opt, arrays)
    cfg = ModelConfig(**cfg_kw)
    sd = convert.jax_params_to_state_dict(_np(jstate.params), cfg)
    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(**opt), device="cpu", seed=0)
    state = ctx.init_state({k: v.clone() for k, v in sd.items()})
    trained = ctx.trained_parameters(state.model)
    assert any("lora_a" in n for n in trained) and "predict_token.weight" in trained
    assert not any(n.startswith("transformer.") and "lora" not in n for n in trained)
    batch = to_device_batch(arrays, "cpu")
    for step in range(3):
        jstate, jloss = jctx.train_step(jstate, jbatch)
        state, loss = ctx.train_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), err_msg=f"step {step}",
                                   **LOSS_TOL)
    want = convert.jax_params_to_state_dict(_np(jstate.params), cfg)
    for name, p in state.model.named_parameters():
        if ts.lora_frozen(name):
            assert torch.equal(p.detach(), sd[name]), name  # bit-unchanged
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                   **PARAM_TOL)
    assert (state.model.transformer.h[0].attn.lora_b.weight != 0).any()


@pytest.mark.parametrize("k", [2, 3])
def test_gradient_accumulation_and_ema_match_multisteps(k):
    opt = dict(OPT, gradient_accumulation_steps=k, ema_decay=0.9)
    arrays = _arrays(images=False, target_budget=128)
    rng = np.random.default_rng(k)
    jctx, jstate, jbatch = _jax_context(TINY, opt, arrays)
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(_np(jstate.params), cfg)
    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(**opt), device="cpu", seed=0)
    state = ctx.init_state({k_: v.clone() for k_, v in sd.items()})
    # a different batch each call: the mean over the window matters
    batches = []
    for _ in range(6):
        a = dict(arrays)
        a["tokens"] = np.where(arrays["input_mask"], rng.integers(0, 256, arrays["tokens"].shape),
                               arrays["tokens"]).astype(arrays["tokens"].dtype)
        batches.append(a)
    from neko_tpu.parallel import sharding as shd

    for call, a in enumerate(batches):
        jstate, jloss = jctx.train_step(jstate, shd.shard_batch(jctx.mesh, jax_batch(a)))
        state, loss = ctx.train_step(state, to_device_batch(a, "cpu"))
        where = f"call {call}"
        np.testing.assert_allclose(loss.item(), float(jloss), err_msg=where, **LOSS_TOL)
        ms = jstate.opt_state
        assert state.step == int(jstate.step) == call + 1
        assert state.mini_step == int(ms.mini_step), where
        assert ctx.update_count(state) == int(ms.gradient_step) == (call + 1) // k, where
        assert set(_counts(ms.inner_opt_state)) == {ctx.update_count(state)}, where
        extras = convert.jax_train_extras_to_torch(_np(jstate.ema_params), _np(ms), cfg)
        assert extras["mini_step"] == state.mini_step
        params = convert.jax_params_to_state_dict(_np(jstate.params), cfg)
        for want, got in ((params, dict(state.model.named_parameters())),
                          (extras["accum"], state.accum), (extras["ema"], state.ema)):
            for name, w in want.items():
                np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                           err_msg=f"{where} {name}", **PARAM_TOL)


# --------------------------------------------------------------------- EMA
def _ctx(tmp_kw=None, **opt):
    cfg = ModelConfig(**dict(TINY, **(tmp_kw or {})))
    return ts.TrainContext(cfg, ts.OptimizerConfig(**dict(OPT, **opt)), device="cpu", seed=0)


def test_ema_closed_form_and_once_per_update():
    d = 0.8
    batch = to_device_batch(_arrays(images=False, target_budget=128), "cpu")
    ctx = _ctx(ema_decay=d)
    state = ctx.init_state()
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    history = []
    for _ in range(3):
        ctx.train_step(state, batch)
        history.append({n: p.detach().clone() for n, p in state.model.named_parameters()})
    for name in p0:  # ema_n = d^n p0 + (1 - d) sum_i d^(n-i) p_i
        want = d ** 3 * p0[name] + (1 - d) * sum(d ** (3 - i) * history[i - 1][name]
                                                 for i in range(1, 4))
        torch.testing.assert_close(state.ema[name], want, rtol=1e-5, atol=1e-6)
    # under k = 2 the shadow moves on the update's call only
    ctx2 = _ctx(ema_decay=d, gradient_accumulation_steps=2)
    state2 = ctx2.init_state()
    before = {n: e.clone() for n, e in state2.ema.items()}
    ctx2.train_step(state2, batch)
    assert all(torch.equal(state2.ema[n], before[n]) for n in before)
    ctx2.train_step(state2, batch)
    p = dict(state2.model.named_parameters())
    for n in before:
        torch.testing.assert_close(state2.ema[n], before[n] * d + p[n].detach() * (1 - d),
                                   rtol=0, atol=0)


def test_ema_checkpoint_round_trip_and_resume(tmp_path):
    batch = to_device_batch(_arrays(images=False, target_budget=128), "cpu")
    opt = dict(ema_decay=0.9, gradient_accumulation_steps=2)
    ctx = _ctx(**opt)
    straight = ctx.init_state()
    for _ in range(5):
        ctx.train_step(straight, batch)
    ctx = _ctx(**opt)
    state = ctx.init_state()
    for _ in range(3):  # stop mid-window
        ctx.train_step(state, batch)
    path = ckpt.save_checkpoint(str(tmp_path), state, state.step)
    assert os.path.isfile(os.path.join(path, ckpt.EMA))
    back = ckpt.load_checkpoint(path, _ctx(**opt))
    assert back.mini_step == state.mini_step == 1
    for name in state.ema:
        assert torch.equal(back.ema[name], state.ema[name])
    for name in state.accum:
        assert torch.equal(back.accum[name], state.accum[name])
    ctx2 = _ctx(**opt)
    for _ in range(2):
        ctx2.train_step(back, batch)
    for name, p in straight.model.named_parameters():
        assert torch.equal(dict(back.model.named_parameters())[name], p), name
        assert torch.equal(back.ema[name], straight.ema[name]), name


def test_a_checkpoint_without_ema_restores_without_it(tmp_path):
    batch = to_device_batch(_arrays(images=False, target_budget=128), "cpu")
    ctx = _ctx()
    state = ctx.init_state()
    ctx.train_step(state, batch)
    path = ckpt.save_checkpoint(str(tmp_path), state, state.step)
    assert not os.path.exists(os.path.join(path, ckpt.EMA))
    saved = torch.load(os.path.join(path, ckpt.TRAIN_STATE), weights_only=True)
    assert set(saved) == {"step", "seed", "optimizer"}  # the layout before EMA
    back = ckpt.load_checkpoint(path, _ctx())
    assert back.ema is None and back.step == 1
    with pytest.raises(ValueError, match="checkpoint has no EMA shadow"):
        ckpt.load_checkpoint(path, _ctx(ema_decay=0.9))
    with pytest.raises(ValueError, match="checkpoint has no EMA shadow"):
        ckpt.load_ema_params(path, ctx.model_cfg)


def test_fused_route_keeps_the_jax_gate_and_runs_ema():
    assert ts.use_fused_adamw(ts.OptimizerConfig(fused_adamw=True, ema_decay=0.9))
    assert not ts.use_fused_adamw(ts.OptimizerConfig(fused_adamw=True, lora_only=True))
    assert not ts.use_fused_adamw(ts.OptimizerConfig(fused_adamw=True,
                                                     gradient_accumulation_steps=2))
    batch = to_device_batch(_arrays(images=False, target_budget=128), "cpu")
    d = 0.9
    ctx = _ctx(fused_adamw=True, ema_decay=d)
    state = ctx.init_state()
    assert isinstance(state.optimizer, ts.FusedAdamW)
    before = {n: e.clone() for n, e in state.ema.items()}
    ctx.train_step(state, batch)
    for n, p in state.model.named_parameters():
        torch.testing.assert_close(state.ema[n], before[n] * d + p.detach() * (1 - d),
                                   rtol=0, atol=0)
