"""Fused AdamW in neko_tpu_torch against neko_tpu on the CPU.

* The plain version of kernel #16 (`fused_adamw_update` on CPU tensors)
  against neko_tpu's `fused_adamw_update` with `use_pallas=True` (the
  `_adamw_kernel` pallas_call in interpret mode on the leaves of 65,536
  elements or more) and `use_pallas=False`, over three steps, below and
  above the clip, and without a clip: every parameter, mu and nu within
  1e-6 absolute, the JAX test's own tolerance (fp32 round-off: the port
  multiplies by host reciprocals of the bias corrections where JAX divides
  by them in fp32).
* Three `TrainContext(OptimizerConfig(fused_adamw=True))` steps against
  neko_tpu's `TrainContext` with `fused_adamw=True` on a one-device CPU
  mesh, both started from the same non-zero moments (one JAX step, carried
  over by `convert.jax_fused_adamw_state_to_torch`): each loss within 1e-5,
  parameters and moments after step 3 within rtol 1e-4 / atol 2e-6, as
  test_torch_train.py holds the default route.
* The fused route against the port's default AdamW route over three steps,
  the optimizer's state through `state_dict`, a missing gradient as a zero
  one, and the moments through `convert` both ways.

The CUDA kernel against the plain version is in test_torch_kernels_cuda.py
(card only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.ops import fused_adamw as jfa  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.ops import fused_adamw as fa  # noqa: E402
from neko_tpu_torch.training import train_state as ts  # noqa: E402

LR, B1, B2, EPS, WD, CLIP = 3e-4, 0.9, 0.95, 1e-8, 0.1, 1.0
UPDATE_TOL = dict(atol=1e-6, rtol=0.0)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.standard_normal((96, 1024)) * 0.02).astype(np.float32),  # pallas leaf
        "b": np.full((64,), 0.1, np.float32),
        "emb": (rng.standard_normal((70, 1000)) * 0.02).astype(np.float32),  # padded tail
        "g": rng.standard_normal((7,)).astype(np.float32),
    }


def _grads(params, gscale, step):
    rng = np.random.default_rng(100 + step)
    return {k: (gscale * (0.5 + 0.1 * step) * np.sign(p + 1e-9)
                * rng.uniform(0.5, 1.5, p.shape)).astype(np.float32)
            for k, p in params.items()}


def _jax_run(params, grads_seq, max_norm, use_pallas):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = jfa.init_fused_adamw_state(p)
    step = jax.jit(lambda p, s, g: jfa.fused_adamw_update(
        p, g, s, lr=LR, b1=B1, b2=B2, eps=EPS, wd=WD, max_norm=max_norm,
        use_pallas=use_pallas))
    for g in grads_seq:
        p, st = step(p, st, {k: jnp.asarray(v) for k, v in g.items()})
    return p, st


def _port_run(params, grads_seq, max_norm):
    keys = list(params)
    p = [torch.from_numpy(params[k].copy()) for k in keys]
    st = fa.init_fused_adamw_state(p)
    for g in grads_seq:
        st = fa.fused_adamw_update(p, [torch.from_numpy(g[k]) for k in keys], st, lr=LR,
                                   b1=B1, b2=B2, eps=EPS, wd=WD, max_norm=max_norm)
    return dict(zip(keys, p)), st


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("gscale,max_norm", [(1e-3, CLIP), (50.0, CLIP), (0.3, None)])
def test_plain_update_matches_jax_over_steps(use_pallas, gscale, max_norm):
    params = _tree(0)
    grads_seq = [_grads(params, gscale, i) for i in range(3)]
    want_p, want_st = _jax_run(params, grads_seq, max_norm, use_pallas)
    got_p, got_st = _port_run(params, grads_seq, max_norm)
    assert got_st.count == int(want_st.count) == 3
    for i, k in enumerate(params):
        np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), err_msg=k,
                                   **UPDATE_TOL)
        np.testing.assert_allclose(got_st.mu[i].numpy(), np.asarray(want_st.mu[k]),
                                   err_msg=k, **UPDATE_TOL)
        np.testing.assert_allclose(got_st.nu[i].numpy(), np.asarray(want_st.nu[k]),
                                   err_msg=k, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_global_norm_and_clip_scale_match_jax(max_norm):
    params = _tree(1)
    g = _grads(params, 0.7, 0)
    want_norm = jfa.global_norm({k: jnp.asarray(v) for k, v in g.items()})
    norm = fa.global_norm([torch.from_numpy(v) for v in g.values()])
    np.testing.assert_allclose(norm.item(), float(want_norm), rtol=1e-6)
    np.testing.assert_allclose(fa.clip_scale_from_norm(norm, max_norm).item(),
                               float(jfa.clip_scale_from_norm(want_norm, max_norm)), rtol=1e-6)
    assert fa.clip_scale_from_norm(torch.tensor(0.0), max_norm).item() == 1.0


@pytest.mark.parametrize("count", [0, 1, 7, 1000])
def test_bias_corrections_match_jax(count):
    want = jfa._bias_corrections(jnp.int32(count), B1, B2)
    np.testing.assert_allclose(fa.bias_corrections(count, B1, B2), [float(w) for w in want],
                               rtol=1e-6)


def test_missing_gradient_is_a_zero_gradient():
    params = _tree(2)
    keys = list(params)
    g = _grads(params, 0.2, 0)
    runs = []
    for grads in ([torch.from_numpy(g[k]) for k in keys[:-1]] + [None],
                  [torch.from_numpy(g[k]) for k in keys[:-1]] + [torch.zeros(7)]):
        p = [torch.from_numpy(params[k].copy()) for k in keys]
        st = fa.fused_adamw_update(p, grads, fa.init_fused_adamw_state(p), lr=LR, b1=B1,
                                   b2=B2, eps=EPS, wd=WD, max_norm=CLIP)
        runs.append((p, st))
    for a, b in zip(runs[0][0] + runs[0][1].mu, runs[1][0] + runs[1][1].mu):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][0][-1], torch.from_numpy(params["g"]))  # decayed


TINY = dict(embed_dim=64, layers=2, heads=2, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0)
OPT = dict(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2, training_steps=10,
           grad_norm_clip=0.5)


def _arrays(target_budget=128):
    rng = np.random.default_rng(0)
    ex = [{"text": rng.integers(0, 256, 40)},
          {"continuous_obs": rng.standard_normal((4, 5)).astype(np.float32),
           "continuous_actions": rng.uniform(-1, 1, (4, 2)).astype(np.float32)},
          {"text": rng.integers(0, 256, 9)}]
    arrays = JaxPacker(JaxConfig(**TINY)).pack_batch(ex, target_budget=target_budget)
    arrays.pop("lengths")
    return arrays


def test_three_fused_train_steps_match_jax_train_context():
    from neko_tpu.parallel import sharding as shd
    from neko_tpu.parallel.mesh import create_mesh
    from neko_tpu.training.train_state import OptimizerConfig as JaxOpt
    from neko_tpu.training.train_state import TrainContext as JaxContext

    arrays = _arrays()
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    jctx = JaxContext(JaxConfig(**TINY), JaxOpt(fused_adamw=True, **OPT), mesh, seed=0)
    jbatch = shd.shard_batch(mesh, jax_batch(arrays))
    jstate = jctx.init_state(jbatch)
    assert isinstance(jstate.opt_state, jfa.FusedAdamWState)
    jstate, _ = jctx.train_step(jstate, jbatch)  # non-zero moments, count 1

    cfg = ModelConfig(**TINY)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    sd = convert.jax_params_to_state_dict(np_tree(jstate.params), cfg)
    moments = convert.jax_fused_adamw_state_to_torch(jstate.opt_state, cfg)
    assert moments["count"] == 1
    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(fused_adamw=True, **OPT), device="cpu",
                          seed=0)
    state = ctx.init_state(sd, fused_adamw_state=moments)
    assert isinstance(state.optimizer, ts.FusedAdamW) and state.step == 1
    batch = to_device_batch(arrays, "cpu")
    for step in range(1, 4):
        jstate, jloss = jctx.train_step(jstate, jbatch)
        state, loss = ctx.train_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), err_msg=f"step {step}",
                                   rtol=1e-5, atol=1e-5)
    assert state.step == state.optimizer.count == int(jstate.opt_state.count) == 4
    want = convert.jax_params_to_state_dict(np_tree(jstate.params), cfg)
    want_m = convert.jax_fused_adamw_state_to_torch(jstate.opt_state, cfg)
    got_m = ctx.fused_adamw_state(state)
    for name, p in state.model.named_parameters():
        for got, w in ((p.detach(), want[name]), (got_m["mu"][name], want_m["mu"][name]),
                       (got_m["nu"][name], want_m["nu"][name])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), err_msg=name, rtol=1e-4,
                                       atol=2e-6)


def test_fused_route_matches_the_default_adamw_route():
    """The same three steps through FusedAdamW and through the clip pass +
    torch.optim.AdamW: the clip formulas differ only below norm 1e-16 and the
    updates in fp32 round-off."""
    cfg = ModelConfig(**TINY)
    sd = convert.init_state_dict(cfg, 3)
    batch = to_device_batch(_arrays(), "cpu")
    runs = []
    for fused in (False, True):
        ctx = ts.TrainContext(cfg, ts.OptimizerConfig(fused_adamw=fused, **OPT), device="cpu")
        state = ctx.init_state({k: v.clone() for k, v in sd.items()})
        losses = [ctx.train_step(state, batch)[1].item() for _ in range(3)]
        runs.append((losses, dict(state.model.named_parameters())))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6, atol=1e-6)
    for name, p in runs[0][1].items():
        got, want = runs[1][1][name].detach(), p.detach()
        # Adam's update is near +-lr wherever |g| >> eps, but turns on the
        # rounding of g (clipped by another formula) where g ~ 0, where one
        # element can move by up to lr: hold each tensor by its relative L2
        assert (got - want).norm().item() <= 1e-3 * want.norm().item(), name


def test_optimizer_state_round_trips():
    cfg = ModelConfig(**TINY)
    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(fused_adamw=True, **OPT), device="cpu")
    state = ctx.init_state()
    ctx.train_step(state, to_device_batch(_arrays(), "cpu"))
    st = ctx.fused_adamw_state(state)
    assert st["count"] == 1 and any(m.abs().sum() > 0 for m in st["mu"].values())
    # through the optimizer's state_dict
    other = ctx.init_state()
    other.optimizer.load_state_dict(state.optimizer.state_dict())
    again = ctx.fused_adamw_state(other)
    assert again["count"] == 1
    for name in st["mu"]:
        assert torch.equal(again["mu"][name], st["mu"][name])
        assert torch.equal(again["nu"][name], st["nu"][name])
    # through neko_tpu's layout and back
    back = convert.jax_fused_adamw_state_to_torch(
        jfa.FusedAdamWState(**convert.torch_fused_adamw_state_to_jax(st, cfg)), cfg)
    assert back["count"] == 1
    for name in st["mu"]:
        assert torch.equal(back["mu"][name], st["mu"][name])
        assert torch.equal(back["nu"][name], st["nu"][name])
    with pytest.raises(ValueError):  # moments need the fused optimizer
        ts.TrainContext(cfg, ts.OptimizerConfig(**OPT), device="cpu").init_state(
            fused_adamw_state=st)
