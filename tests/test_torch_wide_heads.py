"""Attention at hd > 128, over the kernels' widest head, in neko_tpu_torch
against neko_tpu on the CPU (weights carried across by convert.py, fp32).
neko_tpu runs its XLA attention there; the port routes every mode to its
plain route (ops/attention.py `wide_attention_qkv` / `wide_attention`, the
plain decode attention) and launches no kernel.

* the loss and every gradient of a train step at hd 160 (one head of 160)
  and hd 256 (2 heads of 256), dropout 0, against `jax.value_and_grad`:
  loss within 1e-5, gradients within rtol 1e-4 / atol 1e-6
  (test_torch_train.py's limits); no attention kernel wrapper is called;
* remat and stochastic depth with dropout at hd 256: remat's loss and
  gradients equal those without it, bit for bit (the recompute replays the
  generator);
* dropout by its statistics: the keep share within 0.01 of 1 - rate over
  262,144 draws (12 standard deviations), and the mean of 100 dropout
  outputs within 6 standard errors of the no-dropout output, element by
  element (E[dropout(x)] = x), the masks drawn from the generator alone;
* a prefill and four decode steps (logits within 1e-4), three ring extends
  with eviction (logits within 1e-5) and greedy `generate_batch` tokens
  equal to neko_tpu's, at hd 160 and 256; the int8 cache at hd 256: the
  prefill logits within 1e-4, the stored int8 rows equal but for at most
  1e-4 of them one step off (an fp32 sum in another order across a rounding
  boundary), and four decode steps over the port's cache on both sides
  within 1e-4;
* a 'seq' axis at hd > 128 (neko_tpu's XLA ring, not ported) is refused by
  name.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.ops import attention as attn  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import blocked_attention as ba  # noqa: E402
from neko_tpu_torch.ops import decode_attention as da  # noqa: E402
from neko_tpu_torch.parallel import mesh as pmesh  # noqa: E402

BASE = dict(layers=2, heads=2, context_len=64, max_patches=4, dtype="float32",
            text_tokens=256, continuous_tokens=64, discrete_tokens=64, dropout=0.0)
WIDTHS = {160: dict(BASE, embed_dim=160, heads=1), 256: dict(BASE, embed_dim=512)}
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
EXTEND_TOL = dict(rtol=1e-5, atol=1e-5)
KEEP_TOL = 0.01
# int8 cache entries allowed one step off neko_tpu's (rounding boundaries)
INT8_FLIP_SHARE = 1e-4
MEAN_Z = 6.0
DRAWS = 100


def _arrays(shape, seed=0):
    rng = np.random.default_rng(seed)
    examples = [{"text": rng.integers(0, 256, 40)},
                {"continuous_obs": rng.standard_normal((4, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (4, 2)).astype(np.float32)},
                {"text": rng.integers(0, 256, 9)}]
    arrays = JaxPacker(JaxConfig(**shape)).pack_batch(examples)
    arrays.pop("lengths")
    return arrays


@functools.lru_cache(maxsize=None)
def _pair(hd, **extra):
    """(jax model, jax params, port config, converted state dict)."""
    shape = dict(WIDTHS[hd], **extra)
    jmodel = JaxModel(JaxConfig(**shape))
    params = jax.jit(jmodel.init)({"params": jax.random.key(7)},
                                  jax_batch(_arrays(shape)))["params"]
    cfg = ModelConfig(**shape)
    assert cfg.head_dim == hd and attn.wide_heads(hd)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jmodel, params, cfg, sd


def _no_kernel_wrapper(monkeypatch):
    """Makes every attention kernel wrapper raise when called."""
    def refuse(*a, **kw):
        raise AssertionError("an attention kernel wrapper ran at hd > 128")

    for mod, name in ((whk, "whole_head_attention"), (whk, "whole_head_attention_qkv"),
                      (ba, "blocked_attention_qkv"), (attn, "decode_cache_attention"),
                      (attn, "decode_cache_attention_int8")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("hd", [160, 256])
def test_train_step_matches_jax(hd, monkeypatch):
    jmodel, params, cfg, sd = _pair(hd)
    arrays = _arrays(WIDTHS[hd])

    def loss_fn(p):
        return jmodel.apply({"params": p}, jax_batch(arrays), deterministic=True,
                            compute_loss=True)[1]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = convert.jax_grads_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    _no_kernel_wrapper(monkeypatch)
    model = convert.build_model(cfg, {k: v.clone() for k, v in sd.items()}, device="cpu")
    g = torch.Generator().manual_seed(0)
    _, loss = model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True, generator=g)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    got = dict(model.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), err_msg=name, **GRAD_TOL)


def test_remat_and_stochastic_depth_with_dropout_at_hd_256():
    _, _, cfg, sd = _pair(256)
    batch = to_device_batch(_arrays(WIDTHS[256]), "cpu")
    runs = []
    for remat in (False, True):
        c = cfg.replace(dropout=0.1, stochastic_depth=0.2, remat=remat)
        model = convert.build_model(c, {k: v.clone() for k, v in sd.items()}, device="cpu")
        _, loss = model(batch, train=True, compute_loss=True,
                        generator=torch.Generator().manual_seed(3))
        loss.backward()
        runs.append((loss, {n: p.grad for n, p in model.named_parameters()}))
    assert np.isfinite(runs[0][0].item())
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
    for name, grad in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name], grad, rtol=0, atol=0, msg=name)


def test_dropout_statistics():
    rng = np.random.default_rng(0)
    B, H, S, hd, rate = 2, 2, 48, 160, 0.25
    qkv = torch.from_numpy(rng.standard_normal((B, S, 3 * H * hd)).astype(np.float32))
    key_mask = torch.ones(B, S, dtype=torch.bool)
    key_mask[1, :5] = False  # a left-padded row: its first query rows see no key
    shape = (4, 4, 128, 128)
    ks = attn.wide_keep_scale(shape, rate, torch.Generator().manual_seed(1), "cpu")
    kept = (ks > 0).float().mean().item()
    assert abs(kept - (1 - rate)) <= KEEP_TOL
    assert set(ks.unique().tolist()) == {0.0, torch.tensor(1 / (1 - rate)).item()}
    same = attn.wide_keep_scale(shape, rate, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(ks, same)  # the generator alone decides the mask
    clean = attn.wide_attention_qkv(qkv, key_mask, heads=H)
    assert not clean[1, :5].any()  # rows with no key are zeros, never NaN
    g = torch.Generator().manual_seed(2)
    draws = torch.stack([attn.wide_attention_qkv(qkv, key_mask, heads=H, generator=g,
                                                 rate=rate) for _ in range(DRAWS)])
    assert torch.isfinite(draws).all()
    # E[dropout(x)] = x: each element's mean within MEAN_Z standard errors
    stderr = draws.std(0) / len(draws) ** 0.5
    z = (draws.mean(0) - clean).abs() / stderr.clamp_min(1e-6)
    assert z.max() <= MEAN_Z, z.max()
    assert (draws[0] - clean).abs().max() > 0.1  # each draw is no copy of the mean


def _prompts(shape, seed):
    rng = np.random.default_rng(seed)
    arrays = JaxPacker(JaxConfig(**shape)).pack_batch(
        [{"text": rng.integers(0, 256, 50)}, {"text": rng.integers(0, 256, 11)}])
    return arrays, arrays.pop("lengths")


def _port_cache_as_jax(jcache, caches):
    """neko_tpu's cache tree with every layer's entries the port's."""
    tree = jax.tree_util.tree_map(lambda x: x, jcache)
    for i, c in enumerate(caches):
        layer = tree["transformer"][f"h_{i}"]["attn"]
        for name in layer:
            layer[name] = jnp.asarray(c[name].numpy())
    return tree


@pytest.mark.parametrize("hd,int8", [(160, False), (256, False), (256, True)],
                         ids=["hd160", "hd256", "hd256-int8"])
def test_prefill_and_decode_match_jax(hd, int8, monkeypatch):
    extra = {"kv_cache_dtype": "int8"} if int8 else {}
    jmodel, params, cfg, sd = _pair(hd, **extra)
    _no_kernel_wrapper(monkeypatch)
    model = convert.build_model(cfg, sd, device="cpu")
    arrays, lengths = _prompts(WIDTHS[hd], 3)
    rng = np.random.default_rng(4)
    emb = np.array(jmodel.apply({"params": params}, jax_batch(arrays),
                                method=JaxModel.embed_batch))
    mask = arrays["input_mask"]
    prefill = jax.jit(lambda p, e, m: jmodel.apply({"params": p}, e, m, method=JaxModel.prefill,
                                                   mutable=["cache"]))
    decode = jax.jit(lambda p, c, e, i: jmodel.apply({"params": p, "cache": c}, e, i,
                                                     method=JaxModel.decode_step,
                                                     mutable=["cache"]))
    want, vars_ = prefill(params, jnp.asarray(emb), jnp.asarray(mask))
    jcache = vars_["cache"]
    with torch.no_grad():
        got, caches = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], **LOGIT_TOL)
    if int8:
        # the stored rows: equal but where an fp32 sum in another order put
        # a value across an int8 rounding boundary (one step); the decode
        # steps then attend the port's cache on both sides
        valid = mask[:, None, :, None]
        for i, c in enumerate(caches):
            for name in ("key", "value"):
                a = c[name].numpy().astype(np.int32)
                b = np.asarray(jcache["transformer"][f"h_{i}"]["attn"][name]).astype(np.int32)
                off = np.abs(a - b) * valid
                assert off.max() <= 1 and (off > 0).mean() <= INT8_FLIP_SHARE, (i, name)
    pos = lengths.astype(np.int32)
    for _ in range(4):
        if int8:
            jcache = _port_cache_as_jax(jcache, caches)
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        e = np.array(jmodel.apply({"params": params}, jnp.asarray(tok),
                                  method=JaxModel.embed_tokens))
        want, vars_ = decode(params, jcache, jnp.asarray(e), jnp.asarray(pos))
        jcache = vars_["cache"]
        with torch.no_grad():
            got = model.decode_step(torch.from_numpy(e), torch.from_numpy(pos), caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        pos = pos + 1


@pytest.mark.parametrize("hd", [160, 256])
def test_extend_and_greedy_generation_match_jax(hd, monkeypatch):
    jmodel, params, cfg, sd = _pair(hd)
    _no_kernel_wrapper(monkeypatch)
    jgen = JaxGenerator(jmodel, params, JaxPacker(JaxConfig(**WIDTHS[hd])))
    gen = Generator(convert.build_model(cfg, sd, device="cpu"))
    rng = np.random.default_rng(0)
    B, S, D, K, tpt = 2, cfg.context_len, cfg.embed_dim, 5, 7
    L = (S // tpt) * tpt
    lengths = np.array([L, 3 * tpt])
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
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXTEND_TOL)
        slot = (slot + tpt) % L
    examples = [{"text": rng.integers(0, 256, n)} for n in (5, 30, 60)]
    kw = dict(max_new_tokens=8, start=0, end=255)  # 61 + 8 > 64: through the ring
    want_t, _ = jgen.generate_batch(examples, **kw)
    got_t, _ = gen.generate_batch(examples, **kw)
    np.testing.assert_array_equal(got_t, want_t)


def test_sequence_parallel_at_wide_heads_is_refused_by_name():
    _, _, cfg, sd = _pair(256)
    model = convert.build_model(cfg, sd, device="cpu")
    batch = to_device_batch(_arrays(WIDTHS[256]), "cpu")
    with pmesh.create_mesh(data=1, seq=2), pytest.raises(
            NotImplementedError, match="sequence-parallel attention at hd=256"):
        model(batch, train=True, compute_loss=True, generator=torch.Generator().manual_seed(0))
    assert da.supported(8, 2, 64, 128) and not da.supported(8, 2, 64, 256)
