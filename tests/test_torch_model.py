"""NekoModel in neko_tpu_torch against neko_tpu's at converted weights (fp32,
CPU): embeddings, prefill logits and decode-step logits; and the serving
prefill's logits against values recorded before the training port."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.data.packing import SequencePacker  # noqa: E402
from neko_tpu_torch.ops import attention as attn_ops  # noqa: E402

TINY = dict(embed_dim=64, layers=2, heads=4, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model) sharing one set of weights."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(1)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), cfg)
    return jmodel, params, convert.build_model(cfg, sd, device="cpu")


def _examples(kind, rng):
    if kind == "text":
        return [{"text": rng.integers(0, 256, 30)}, {"text": rng.integers(0, 256, 7)}]
    if kind == "control":
        return [{"continuous_obs": rng.standard_normal((3, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (3, 2)).astype(np.float32)},
                {"discrete_obs": rng.integers(0, 64, (4, 2)),
                 "discrete_actions": rng.integers(0, 64, (4, 1))}]
    return [{"images": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
             "discrete_actions": rng.integers(0, 18, (2, 1))},
            {"text": rng.integers(0, 256, 5)}]


def _packed(kind, pad_side="right"):
    examples = _examples(kind, np.random.default_rng(len(kind)))
    arrays = SequencePacker(ModelConfig(**TINY)).pack_batch(examples, pad_side=pad_side)
    lengths = arrays.pop("lengths")
    return arrays, lengths


@pytest.mark.parametrize("kind", ["text", "control", "images"])
def test_embed_batch_matches(pair, kind):
    jmodel, params, model = pair
    arrays, _ = _packed(kind)
    want = jmodel.apply({"params": params}, jax_batch(arrays),
                        method=JaxModel.embed_batch)
    with torch.no_grad():
        got = model.embed_batch(to_device_batch(arrays, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_prefill(jmodel, params, emb, mask):
    logits, vars_ = jmodel.apply(
        {"params": params}, jnp.asarray(emb), jnp.asarray(mask),
        method=JaxModel.prefill, mutable=["cache"])
    return np.asarray(logits), vars_["cache"]


@pytest.mark.parametrize("pad_side", ["right", "left"])
def test_prefill_logits_match(pair, pad_side):
    jmodel, params, model = pair
    arrays, _ = _packed("images", pad_side)
    emb = np.array(jmodel.apply({"params": params}, jax_batch(arrays),
                                 method=JaxModel.embed_batch))
    mask = arrays["input_mask"]
    want, _ = _jax_prefill(jmodel, params, emb, mask)
    with torch.no_grad():
        got, caches = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    assert len(caches) == TINY["layers"]
    assert caches[0]["key"].shape == (2, 4, 64, 16)
    # a valid query row sees exactly the valid keys at or before it
    rows = np.arange(64)[None, :] >= mask.argmax(1)[:, None]
    np.testing.assert_allclose(got.numpy()[rows], want[rows], **TOL)


def test_prefill_last_positions_and_xla_impl(pair, monkeypatch):
    jmodel, params, model = pair
    arrays, lengths = _packed("text")
    emb = torch.from_numpy(np.array(jmodel.apply(
        {"params": params}, jax_batch(arrays), method=JaxModel.embed_batch)))
    mask = torch.from_numpy(arrays["input_mask"])
    last = torch.from_numpy(lengths.astype(np.int64) - 1)
    # a converted attention_impl='xla' config still prefills through the
    # kernel wrapper: the port has one prefill path
    xla_cfg = convert.build_model(model.cfg.replace(attention_impl="xla"), model.state_dict(),
                                   device="cpu")
    wrapper, calls = attn_ops.prefill_attention, []
    monkeypatch.setattr(attn_ops, "prefill_attention",
                        lambda *a: calls.append(1) or wrapper(*a))
    with torch.no_grad():
        full, _ = model.prefill(emb, mask)
        at_last, _ = model.prefill(emb, mask, last=last)
        cfg_last, _ = xla_cfg.prefill(emb, mask, last=last)
        assert len(calls) == 3 * TINY["layers"]
        monkeypatch.setattr(attn_ops, "prefill_attention", attn_ops.xla_attention)
        xla_last, _ = model.prefill(emb, mask, last=last)
    torch.testing.assert_close(at_last, full[torch.arange(2), last], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cfg_last, at_last, rtol=0, atol=0)
    torch.testing.assert_close(xla_last, at_last, rtol=1e-5, atol=1e-5)


def test_decode_steps_match(pair):
    jmodel, params, model = pair
    arrays, lengths = _packed("text")
    emb = np.array(jmodel.apply({"params": params}, jax_batch(arrays),
                                 method=JaxModel.embed_batch))
    mask = arrays["input_mask"]
    _, jcache = _jax_prefill(jmodel, params, emb, mask)
    with torch.no_grad():
        _, caches = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    rng = np.random.default_rng(7)
    pos = lengths.astype(np.int32)
    for step in range(4):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        e = np.array(jmodel.apply({"params": params}, jnp.asarray(tok),
                                   method=JaxModel.embed_tokens))
        want, vars_ = jmodel.apply(
            {"params": params, "cache": jcache}, jnp.asarray(e), jnp.asarray(pos),
            method=JaxModel.decode_step, mutable=["cache"])
        jcache = vars_["cache"]
        with torch.no_grad():
            got_e = model.embed_tokens(torch.from_numpy(tok))
            got = model.decode_step(got_e, torch.from_numpy(pos), caches)
        np.testing.assert_allclose(got_e.numpy(), e, **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        pos = pos + 1


def test_prefill_logits_unchanged_by_the_training_port():
    """The serving prefill keeps its kernel call (contiguous strides, no
    dropout) and its casts: last-position logits equal those recorded from
    the serving-only port (same seed, same batch) within fp32 rounding."""
    cfg = ModelConfig(**dict(TINY, heads=2))
    model = convert.build_model(cfg, convert.init_state_dict(cfg, seed=3), device="cpu")
    rng = np.random.default_rng(11)
    ex = [{"images": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
           "discrete_actions": rng.integers(0, 18, (2, 1))},
          {"text": rng.integers(0, 256, 20)}]
    arrays = SequencePacker(cfg).pack_batch(ex, pad_side="right")
    lengths = arrays.pop("lengths")
    batch = to_device_batch(arrays, "cpu")
    with torch.no_grad():
        last = torch.from_numpy(lengths.astype(np.int64) - 1)
        logits, _ = model.prefill(model.embed_batch(batch), batch.input_mask, last=last)
    recorded = [[0.21568632125854492, -0.1685284823179245, 0.09275259077548981,
                 -0.020075321197509766, 0.2683062255382538, 0.0012288689613342285],
                [-0.1527048647403717, -0.19313320517539978, 0.4770423173904419,
                 -0.3822905719280243, 0.1620890200138092, -0.10247081518173218]]
    np.testing.assert_allclose(logits[:, :6].numpy(), recorded, rtol=1e-6, atol=1e-7)
    V = cfg.vocab_size
    np.testing.assert_allclose(logits[:, :V].double().sum().item(), 6.819533975794911,
                               rtol=1e-6)
    np.testing.assert_allclose(logits[:, :V].abs().double().sum().item(), 99.219008365646,
                               rtol=1e-6)
