"""Stochastic depth and remat of neko_tpu_torch against neko_tpu on the CPU
(fp32, tiny config, weights carried across by convert.py, the tolerances
of tests/test_torch_train.py; the helpers of tests/test_torch_train_features.py):

* stochastic depth: the eval path unaffected, sd = 0 inert, the ramp, an
  unbiased expectation, and neko_tpu's loss and gradients when the same
  keep masks are injected into both (their dropout streams differ);
* remat: loss and every gradient bit-equal to no remat under dropout and
  stochastic depth from the same step generator, the generator ending in
  the same state, also under a sequence mesh; a planted recompute from the
  live generator must break that.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.models import transformer as tfm  # noqa: E402
from neko_tpu_torch.parallel import mesh as pmesh  # noqa: E402

from tests.test_torch_train import LOSS_TOL, TINY, _arrays  # noqa: E402
from tests.test_torch_train_features import (  # noqa: E402
    _check_grads, _init_jax, _np, _port_value_and_grad, _value_and_grad_jax)


# -------------------------------------------------------- stochastic depth
SD = dict(TINY, layers=3)


def test_stochastic_depth_ramp_and_eval_path():
    cfg = ModelConfig(**SD, stochastic_depth=0.4)
    sd = convert.init_state_dict(cfg, 0)
    model = convert.build_model(cfg, sd, device="cpu")
    assert [b.sd_rate for b in model.transformer.h] == pytest.approx([0.0, 0.2, 0.4])
    plain = convert.build_model(ModelConfig(**SD), sd, device="cpu")
    batch = to_device_batch(_arrays(), "cpu")
    with torch.no_grad():
        a = model(batch, return_logits=True)[0]
        b = plain(batch, return_logits=True)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stochastic_depth_zero_is_inert(monkeypatch):
    cfg = ModelConfig(**dict(SD, dropout=0.1))
    sd = convert.init_state_dict(cfg, 0)
    arrays = _arrays()
    g1 = torch.Generator().manual_seed(4)
    m1, l1, _ = _port_value_and_grad(cfg, sd, arrays, generator=g1)
    monkeypatch.setattr(tfm.Block, "_residual", lambda self, x, branch, g: x + branch)
    g2 = torch.Generator().manual_seed(4)
    m2, l2, _ = _port_value_and_grad(cfg, sd, arrays, generator=g2)
    assert torch.equal(l1, l2) and torch.equal(g1.get_state(), g2.get_state())
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p.grad, q.grad), n


def test_stochastic_depth_expectation_is_unbiased():
    cfg = ModelConfig(**SD, stochastic_depth=0.4)
    model = convert.build_model(cfg, convert.init_state_dict(cfg, 1), device="cpu")
    batch = to_device_batch(_arrays(images=False), "cpu")
    with torch.no_grad():
        det = model(batch, return_logits=True)[0]
        g = torch.Generator().manual_seed(0)
        draws = [model(batch, train=True, return_logits=True, generator=g)[0]
                 for _ in range(100)]
    mean = torch.stack(draws).mean(0)
    # unbiased per branch, not per network: the Monte-Carlo mean sits far
    # closer to the deterministic forward than one draw does
    assert (mean - det).abs().mean() < 0.5 * (draws[0] - det).abs().mean()


def test_stochastic_depth_matches_jax_with_injected_masks(monkeypatch):
    kw = dict(SD, stochastic_depth=0.5)
    arrays = _arrays(images=False)
    B = arrays["tokens"].shape[0]
    rng = np.random.default_rng(9)
    masks = [rng.random((B, 1, 1)) < 0.5 for _ in range(4)]  # layers 1 and 2, two each
    masks[0][0] = masks[0][1] = True
    jmodel, params = _init_jax(kw, arrays)
    jax_calls = []

    def fake_bernoulli(key, p, shape):
        jax_calls.append(float(p))
        return jnp.asarray(masks[len(jax_calls) - 1].reshape(shape))

    with monkeypatch.context() as m:
        m.setattr(jax.random, "bernoulli", fake_bernoulli)
        rngs = {"dropout": jax.random.key(0), "patch_pos": jax.random.key(1)}
        want_loss, _, want_grads = _value_and_grad_jax(jmodel, params, arrays, rngs=rngs)
    port_calls = []

    def fake_keep(shape, keep_p, generator, device):
        port_calls.append(keep_p)
        return torch.from_numpy(masks[len(port_calls) - 1]).reshape(shape)

    monkeypatch.setattr(tfm, "drop_path_keep", fake_keep)
    cfg = ModelConfig(**kw)
    sd = convert.jax_params_to_state_dict(_np(params), cfg)
    model, loss, _ = _port_value_and_grad(cfg, sd, arrays, generator=torch.Generator())
    assert jax_calls == pytest.approx([0.75, 0.75, 0.5, 0.5])
    assert port_calls == pytest.approx(jax_calls)
    np.testing.assert_allclose(loss.item(), want_loss, **LOSS_TOL)
    _check_grads(model, want_grads, cfg)


# ------------------------------------------------------------------- remat
REMAT = dict(TINY, layers=3, dropout=0.1, stochastic_depth=0.1, lora_r=4,
             lora_dropout=0.1, activation_fn="geglu")


def _remat_pair(mesh=None):
    """(loss, grads, generator state) with remat off and on, from one step
    generator."""
    out = []
    for remat in (False, True):
        cfg = ModelConfig(**dict(REMAT, remat=remat))
        model = convert.build_model(cfg, convert.init_state_dict(cfg, 0), device="cpu")
        g = torch.Generator().manual_seed(11)
        with mesh or contextlib.nullcontext():
            _, loss = model(to_device_batch(_arrays(), "cpu"), train=True, compute_loss=True,
                            generator=g)
        loss.backward()  # outside the mesh, as TrainContext runs it
        out.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                    g.get_state()))
    return out


def _bit_equal(pair):
    (l0, g0, s0), (l1, g1, s1) = pair
    return (torch.equal(l0, l1) and torch.equal(s0, s1)
            and all(torch.equal(g0[n], g1[n]) for n in g0))


@pytest.mark.parametrize("seq", [1, 2])
def test_remat_is_bit_identical_under_dropout_and_stochastic_depth(seq):
    mesh = pmesh.create_mesh(data=1, seq=seq) if seq > 1 else None
    pair = _remat_pair(mesh)
    assert _bit_equal(pair)
    assert all(g is not None for g in pair[1][1].values())


def test_remat_from_the_live_generator_is_caught(monkeypatch):
    monkeypatch.setattr(tfm, "replay_generator", lambda generator, state: generator)
    assert not _bit_equal(_remat_pair())


def test_remat_recomputes_each_layers_attention(monkeypatch):
    from neko_tpu_torch.ops import attention as attn_ops

    calls = []
    fn = attn_ops.attention_qkv
    monkeypatch.setattr(attn_ops, "attention_qkv",
                        lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    cfg = ModelConfig(**dict(REMAT, remat=True))
    model = convert.build_model(cfg, convert.init_state_dict(cfg, 0), device="cpu")
    _, loss = model(to_device_batch(_arrays(), "cpu"), train=True, compute_loss=True,
                    generator=torch.Generator().manual_seed(0))
    assert len(calls) == cfg.layers
    loss.backward()
    assert len(calls) == 2 * cfg.layers
