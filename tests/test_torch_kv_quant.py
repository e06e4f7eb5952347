"""The int8 KV cache of neko_tpu_torch (`ModelConfig.kv_cache_dtype='int8'`)
against neko_tpu's on the CPU at converted weights (64d, 2 layers, 4 heads,
k = 64, fp32; neko_tpu's tests/test_kv_quant.py width):

* `quant_rows` against `_quant_rows`: int8 rows bit for bit (all-zero rows
  too), scales within rtol 1e-6;
* the plain `quant_cache_attention` and #14-int8's plain version (a window,
  holes in the mask, a row with no key, an hd the wrapper pads) against
  `_quant_cache_attention`, atol 1e-5;
* generation with an int8 cache against neko_tpu's int8 generation: tokens
  equal, window logits within 1e-4, within the context and through the
  ring past it (the window overflow); the prefill's cache int8 rows bit
  for bit and its scales; the decode step's rows and scales;
* beams, prompt-lookup speculation, the continuous engine and the rollout
  cache's ring extend over an int8 cache, each against neko_tpu's.
"""

import dataclasses

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
from neko_tpu.models.transformer import _quant_cache_attention, _quant_rows  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_cache_attention_int8, quant_cache_attention, quant_rows)

TINY = dict(embed_dim=64, layers=2, heads=4, dropout=0.0, context_len=64, max_patches=0,
            dtype="float32", text_tokens=128, continuous_tokens=64, discrete_tokens=64)
LOGIT_ATOL = 1e-4
ATTN_ATOL = 1e-5
PROMPT = [5, 17, 99, 3, 42, 8]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def weights(tiny, seed=0):
    """neko_tpu's random initial params of a config and their state dict."""
    jcfg = JaxConfig(**tiny)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = JaxModel(jcfg).init({"params": jax.random.key(seed)}, jax_batch(arrays))["params"]
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                          ModelConfig(**tiny))
    return params, sd


def pair(params, sd, tiny, kv="native", weights=None, seed=0):
    """(neko_tpu's Generator, the port's) of one cache and weight dtype."""
    jcfg = dataclasses.replace(JaxConfig(**tiny), kv_cache_dtype=kv)
    cfg = ModelConfig(**tiny).replace(kv_cache_dtype=kv)
    return (JaxGenerator(JaxModel(jcfg), params, JaxPacker(jcfg), seed=seed,
                         weight_dtype=weights),
            Generator(convert.build_model(cfg, sd, device="cpu"), seed=seed,
                      weight_dtype=weights))


@pytest.fixture(scope="module")
def gens():
    params, sd = weights(TINY)
    return pair(params, sd, TINY, kv="int8")


def _text(gen):
    ts = gen.cfg.token_space
    return dict(start=ts.start("text"), end=ts.end("text"))


def test_quant_rows_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 7, 32)).astype(np.float32) * 4.0
    x[0, 1, 2] = 0.0  # an all-zero row: scale 0, zeros
    wq, ws = _quant_rows(jnp.asarray(x))
    q, s = quant_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6, atol=0)
    assert s[0, 1, 2] == 0 and (q[0, 1, 2] == 0).all()


def _qkv(rng, B, H, Sq, Sk, hd):
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, H, Sk, hd)).astype(np.float32) * 2.0
    v = rng.standard_normal((B, H, Sk, hd)).astype(np.float32)
    return q, k, v


def test_quant_cache_attention_matches_jax():
    """The plain version of extend's attention (several queries, a ragged
    allowed set) against neko_tpu's with the matching -1e9 bias."""
    rng = np.random.default_rng(1)
    B, H, Sq, Sk, hd = 2, 4, 3, 48, 32
    q, k, v = _qkv(rng, B, H, Sq, Sk, hd)
    allowed = rng.random((B, 1, Sq, Sk)) < 0.7
    kq, ks = _quant_rows(jnp.asarray(k))
    vq, vs = _quant_rows(jnp.asarray(v))
    bias = jnp.where(jnp.asarray(allowed), 0.0, -1e9).astype(jnp.float32)
    want = _quant_cache_attention(jnp.asarray(q), kq, ks, vq, vs, bias)
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    got = quant_cache_attention(torch.from_numpy(q), *t, torch.from_numpy(allowed))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("hd", [32, 24])
def test_int8_decode_plain_matches_jax(hd):
    """#14-int8's wrapper on CPU tensors (its plain version; hd 24 zero-pads
    to 32): windows, mask holes and a row with no key (0, never NaN)."""
    rng = np.random.default_rng(2)
    B, H, S = 4, 3, 40
    q, k, v = _qkv(rng, B, H, 1, S, hd)
    start = np.array([0, 5, 0, 10], np.int32)
    end = np.array([40, 33, 1, 10], np.int32)  # the last row: an empty window
    mask = rng.random((B, S)) < 0.8
    mask[2, 0] = True
    kq, ks = _quant_rows(jnp.asarray(k))
    vq, vs = _quant_rows(jnp.asarray(v))
    j = np.arange(S)
    ok = (j >= start[:, None]) & (j < end[:, None]) & mask
    bias = jnp.where(jnp.asarray(ok[:, None, None, :]), 0.0, -1e9).astype(jnp.float32)
    want = np.array(_quant_cache_attention(jnp.asarray(q), kq, ks, vq, vs, bias))[:, :, 0]
    want[~ok.any(1)] = 0.0
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    got = decode_cache_attention_int8(torch.from_numpy(q[:, :, 0]), *t,
                                      torch.from_numpy(start), torch.from_numpy(end),
                                      torch.from_numpy(mask))
    assert got.shape == (B, H, hd) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("case", ["plain", "overflow"])
def test_int8_generation_matches_jax(gens, case):
    """Tokens equal and logits within LOGIT_ATOL; "overflow" leaves 8 free
    positions, then the decode wraps the ring (tests/test_kv_quant.py's
    window overflow) over a second, short row."""
    jgen, gen = gens
    examples = ([{"text": PROMPT}, {"text": [88, 2, 41]}] if case == "plain" else
                [{"text": list(range(5, 5 + TINY["context_len"] - 8))}, {"text": [7, 3]}])
    n = 12 if case == "plain" else 24
    want_t, want_w = jgen.generate_batch(examples, max_new_tokens=n, **_text(gen))
    got_t, got_w = gen.generate_batch(examples, max_new_tokens=n, **_text(gen))
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_allclose(got_w, np.asarray(want_w), atol=LOGIT_ATOL, rtol=0)


def test_int8_cache_structure_and_rows_match_jax(gens):
    """The prefill's cache: int8 keys / values bit for bit with neko_tpu's,
    fp32 scales [B, H, S]; one decode step writes its row and scales."""
    jgen, gen = gens
    arrays = gen.packer.pack_batch([{"text": [5, 17, 99]}], pad_side="right")
    L = int(arrays.pop("lengths")[0])
    mask = np.arange(TINY["context_len"])[None, :] < L
    jemb = jgen._embed_batch(jgen.params, jax_batch(arrays))
    _, jcache = jgen._prefill(jgen.params, jemb, jnp.asarray(mask))
    want = jcache["transformer"]["h_0"]["attn"]
    from neko_tpu_torch.data.batch import to_device_batch

    with torch.inference_mode():
        emb = gen.model.embed_batch(to_device_batch(arrays, "cpu"))
        _, caches = gen.model.prefill(emb, torch.from_numpy(mask))
        c = caches[0]
        assert c["key"].dtype == c["value"].dtype == torch.int8
        assert c["key_scale"].dtype == torch.float32
        assert c["key_scale"].shape == c["key"].shape[:-1] == (1, 4, TINY["context_len"])
        for name in ("key", "value"):
            np.testing.assert_array_equal(c[name][0, :, :L].numpy(),
                                          np.asarray(want[name])[0, :, :L])
            np.testing.assert_allclose(c[name + "_scale"][0, :, :L].numpy(),
                                       np.asarray(want[name + "_scale"])[0, :, :L], rtol=1e-6)
        before = c["key"].clone()
        tok = gen.model.embed_tokens(torch.tensor([[9]]))
        gen.model.decode_step(tok, torch.tensor([L]), caches)
        assert (c["key_scale"][0, :, L] > 0).all() and c["mask"][0, L]
        assert torch.equal(c["key"][:, :, :L], before[:, :, :L])


def test_int8_beams_match_jax(gens):
    jgen, gen = gens
    kw = dict(max_new_tokens=6, num_beams=3, return_logits=True, **_text(gen))
    examples = [{"text": PROMPT}, {"text": [88, 2, 41]}]
    want = jgen.generate_beam(examples, **kw)
    got = gen.generate_beam(examples, **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=LOGIT_ATOL, rtol=0)


def test_int8_lookup_speculation_matches_jax(gens):
    """Prompt lookup over an int8 cache (tests/test_spec_decode.py:106's
    repeating prompt): greedy tokens and rounds equal neko_tpu's and
    generate's."""
    jgen, gen = gens
    prompt = {"text": [7, 3, 9, 7, 3, 9, 7, 3]}
    want, wrounds = jgen.generate_spec(prompt, max_new_tokens=12, speculate_k=3, **_text(gen))
    got, rounds = gen.generate_spec(prompt, max_new_tokens=12, speculate_k=3, **_text(gen))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rounds == int(wrounds)
    (plain,) = gen.generate_batch([prompt], max_new_tokens=12, return_logits=False,
                                  **_text(gen))
    np.testing.assert_array_equal(got, plain[0])


def test_int8_engine_matches_jax(gens):
    """The engine over int8 slots: mid-flight admission, a plain chunk, spec
    rounds, a plain chunk after them; every row's tokens equal neko_tpu's."""
    jgen, gen = gens
    s = _text(gen)
    det, one = np.ones(2, bool), np.ones(2, np.float32)

    def run(g, **rng):
        st = g.engine_init(2, speculate_k=2)
        assert "key_scale" in st["caches"][0] if g is gen else True
        st = g.engine_admit(st, 1, {"text": PROMPT})
        t1, st = g.engine_chunk(st, n_steps=3, det=det, temp=one, top_p=one, **s, **rng)
        st = g.engine_admit(st, 0, {"text": [9, 9, 2, 9, 9]})
        c, a, st = g.engine_spec_chunk(st, rounds=2, K=2, **s, **rng)
        t2, st = g.engine_chunk(st, n_steps=4, det=det, temp=one, top_p=one, **s, **rng)
        return np.asarray(t1), np.asarray(c), np.asarray(a), np.asarray(t2)

    want = run(jgen, rng=jax.random.key(0))
    got = run(gen, generator=torch.Generator().manual_seed(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_int8_rollout_ring_extend_matches_jax(gens):
    """The rollout cache over an int8 cache: each step's ring extend writes
    quantized rows and scales at wrapped positions; the actions equal
    neko_tpu's past two turns of the ring."""
    jgen, gen = gens
    kw = dict(obs_str="continuous_obs", action_str="continuous_actions", obs_tokens=6,
              action_tokens=2, action_kind="continuous", context_timesteps=4)
    jsess, sess = jgen.rollout_session(**kw), gen.rollout_session(**kw)
    jsess.start([None, None])
    sess.start([None, None])
    rng = np.random.default_rng(3)
    for t in range(9):
        obs = [rng.standard_normal((1, 6)).astype(np.float32) for _ in range(2)]
        for g, w in zip(sess.step(obs), jsess.step(obs)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f"step {t}")
