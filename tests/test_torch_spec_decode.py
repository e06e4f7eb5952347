"""Speculative decoding of neko_tpu_torch against neko_tpu's on the CPU, at
converted weights (fp32), the cases of tests/test_spec_decode.py and
tests/test_spec_draft.py:

* the append mode of `extend_step` (no `extend_clear`): logits within 1e-5
  of neko_tpu's over two rounds, the second covering the first's tail;
* `generate_spec` (prompt lookup) and `generate_spec_draft` (an independent
  draft, the target itself, `truncated_draft`): greedy tokens identical to
  neko_tpu's and to the port's `generate`, for one example and a batch,
  and `rounds` equal to neko_tpu's;
* sampled speculation keeps the target distribution: per-position
  marginals against plain sampling on 192 rows x 8 seeds x 3 tokens, total
  variation < 0.1 per position over the 16-token discrete window (the
  samples, window and limit of tests/test_spec_decode.py; at this sample
  count the TV of two plain runs over a near-uniform 64-token window is
  already ~0.12);
  a temperature of 1e-4 gives the greedy tokens;
* refusals: images for prompt lookup, a draft of another token space.
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

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
TV_MAX = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, **kw):
    """(neko_tpu Generator, port Generator) at the same random weights."""
    arch = dict(dropout=0.0, max_patches=0, dtype="float32", text_tokens=128,
                continuous_tokens=64, discrete_tokens=16, **kw)
    jcfg = JaxConfig(**arch)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(seed)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**arch)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return (JaxGenerator(jmodel, params, JaxPacker(jcfg), seed=seed + 100),
            Generator(convert.build_model(cfg, sd, device="cpu"), seed=seed + 100))


@pytest.fixture(scope="module")
def tgt():
    return _pair(0, embed_dim=64, layers=2, heads=4, context_len=64)


@pytest.fixture(scope="module")
def drf():  # narrower and shallower than the target, its own init
    return _pair(7, embed_dim=32, layers=1, heads=2, context_len=64)


def _text(gen):
    ts = gen.cfg.token_space
    return dict(start=ts.start("text"), end=ts.end("text"))


def _plain(gen, prompts, n):
    (toks,) = gen.generate_batch(prompts, max_new_tokens=n, return_logits=False, **_text(gen))
    return toks


def test_append_extend_matches_jax(tgt):
    jgen, gen = tgt
    rng = np.random.default_rng(0)
    B, S, D, K = 2, 64, 64, 5
    lengths = np.array([20, 7])
    emb = rng.standard_normal((B, S, D)).astype(np.float32)
    mask = np.arange(S)[None, :] < lengths[:, None]
    _, jcache = jgen._prefill(jgen.params, jnp.asarray(emb), jnp.asarray(mask))
    with torch.inference_mode():
        _, caches = gen.model.prefill(torch.from_numpy(emb), torch.from_numpy(mask),
                                      last=torch.zeros(B, dtype=torch.long))
    pos = lengths.copy()
    for adv in ([3, 1], [5, 6]):  # the second round covers the first's stale tail
        chunk = rng.standard_normal((B, K, D)).astype(np.float32)
        want, vars_ = jgen.model.apply(
            {"params": jgen.params, "cache": jcache}, jnp.asarray(chunk),
            jnp.asarray(pos, jnp.int32), method=JaxModel.extend_step, mutable=["cache"])
        jcache = vars_["cache"]
        with torch.inference_mode():
            got = gen.model.extend_step(torch.from_numpy(chunk), torch.from_numpy(pos),
                                        caches=caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        jc = jcache["transformer"]["h_1"]["attn"]
        for name in ("key", "value"):
            np.testing.assert_allclose(caches[1][name].numpy(), np.asarray(jc[name]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(caches[1]["mask"].numpy(), np.asarray(jc["mask"]))
        pos = pos + np.asarray(adv)


PROMPTS = [[5, 9, 2, 77, 3], [7, 8, 7, 8, 7, 8, 7, 8], [42], [3, 3, 3, 3, 3, 3]]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("p", range(len(PROMPTS)))
def test_lookup_greedy_matches_jax_and_generate(tgt, p, k):
    jgen, gen = tgt
    ex = {"text": PROMPTS[p]}
    want, want_rounds = jgen.generate_spec(ex, max_new_tokens=12, speculate_k=k, **_text(gen))
    got, rounds = gen.generate_spec(ex, max_new_tokens=12, speculate_k=k, **_text(gen))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _plain(gen, [ex], 12)[0])
    assert rounds == want_rounds and 1 <= rounds <= 12


@pytest.mark.parametrize("ngram", [1, 3])
def test_lookup_batched_matches_jax(tgt, ngram):
    jgen, gen = tgt
    prompts = [{"text": PROMPTS[i]} for i in (0, 1, 3)]
    kw = dict(max_new_tokens=10, speculate_k=3, lookup_ngram=ngram, **_text(gen))
    want, want_rounds = jgen.generate_spec(prompts, **kw)
    got, rounds = gen.generate_spec(prompts, **kw)
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _plain(gen, prompts, 10))
    assert rounds == want_rounds


def test_lookup_accepts_on_a_cycle(tgt):
    """A greedy continuation that cycles is produced in fewer rounds than
    tokens once the cycle is in the history, as in neko_tpu."""
    jgen, gen = tgt
    for seed_tok in range(1, 40):
        greedy = _plain(gen, [{"text": [seed_tok]}], 24)[0]
        if len(set(greedy[8:].tolist())) <= 4:
            kw = dict(max_new_tokens=24, speculate_k=4, **_text(gen))
            got, rounds = gen.generate_spec({"text": [seed_tok]}, **kw)
            _, want_rounds = jgen.generate_spec({"text": [seed_tok]}, **kw)
            np.testing.assert_array_equal(got, greedy)
            assert rounds == want_rounds and rounds < 24
            return
    pytest.fail("no cyclic greedy continuation among the first 40 one-token prompts")


def _marginals(fn, start, W, T, R, seed0):
    counts = np.zeros((T, W), np.int64)
    for r in range(R):
        toks = fn(torch.Generator().manual_seed(seed0 + r))
        for t in range(T):
            counts[t] += np.bincount(toks[:, t] - start, minlength=W)
    return counts / counts.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("route", ["lookup", "draft"])
def test_sampled_keeps_the_target_distribution(tgt, drf, route):
    _, gen = tgt
    ts = gen.cfg.token_space
    start, end = ts.start("discrete"), ts.end("discrete")
    N, R, T = 192, 8, 3
    prompts = [{"text": [7, 8, 7, 8]}] * N
    kw = dict(max_new_tokens=T, start=start, end=end, speculate_k=2, deterministic=False)
    if route == "lookup":
        spec = lambda g: gen.generate_spec(prompts, generator=g, **kw)[0]  # noqa: E731
    else:
        spec = lambda g: gen.generate_spec_draft(prompts, drf[1], generator=g, **kw)[0]  # noqa: E731
    p_spec = _marginals(spec, start, end - start + 1, T, R, 1000)
    p_plain = _marginals(lambda g: gen.generate_batch(
        prompts, max_new_tokens=T, start=start, end=end, deterministic=False, generator=g,
        return_logits=False)[0], start, end - start + 1, T, R, 2000)
    tv = 0.5 * np.abs(p_spec - p_plain).sum(axis=1)
    assert (tv < TV_MAX).all(), f"per-position TV distances {tv}"


@pytest.mark.parametrize("route", ["lookup", "draft"])
def test_sampled_tiny_temperature_is_greedy(tgt, drf, route):
    _, gen = tgt
    ex, kw = {"text": [5, 9, 2]}, dict(max_new_tokens=8, **_text(tgt[1]))
    if route == "lookup":
        fn = gen.generate_spec
    else:
        fn = lambda *a, **k: gen.generate_spec_draft(a[0], drf[1], **k)  # noqa: E731
    greedy, _ = fn(ex, **kw)
    sampled, _ = fn(ex, deterministic=False, temperature=1e-4,
                    generator=torch.Generator().manual_seed(3), **kw)
    np.testing.assert_array_equal(greedy, sampled)


@pytest.mark.parametrize("prompt,k", [([5, 17, 99, 3, 42, 8], 4), ([7, 7, 7, 7], 2), ([1], 6)])
def test_draft_greedy_matches_jax(tgt, drf, prompt, k):
    (jgen, gen), (jdraft, draft) = tgt, drf
    ex, kw = {"text": prompt}, dict(max_new_tokens=16, speculate_k=k, **_text(gen))
    want, want_rounds = jgen.generate_spec_draft(ex, jdraft, **kw)
    got, rounds = gen.generate_spec_draft(ex, draft, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _plain(gen, [ex], 16)[0])
    assert rounds == want_rounds


def test_draft_batched_matches_jax(tgt, drf):
    (jgen, gen), (jdraft, draft) = tgt, drf
    prompts = [{"text": [5, 17, 99]}, {"text": [8, 8, 8, 8, 8]}, {"text": [3]}]
    kw = dict(max_new_tokens=10, speculate_k=3, **_text(gen))
    want, want_rounds = jgen.generate_spec_draft(prompts, jdraft, **kw)
    got, rounds = gen.generate_spec_draft(prompts, draft, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _plain(gen, prompts, 10))
    assert rounds == want_rounds


def test_self_draft_collapses_rounds(tgt):
    _, gen = tgt
    ex = {"text": [5, 17, 99, 3, 42, 8]}
    toks, rounds = gen.generate_spec_draft(ex, gen, max_new_tokens=16, speculate_k=4,
                                           **_text(gen))
    np.testing.assert_array_equal(toks, _plain(gen, [ex], 16)[0])
    assert rounds <= 5  # 16 tokens at 5 a round, + 1 for ties


def test_truncated_draft_matches_jax(tgt):
    jgen, gen = tgt
    ex, kw = {"text": [5, 17, 99, 3, 42, 8]}, dict(max_new_tokens=12, speculate_k=3,
                                                   **_text(gen))
    draft = gen.truncated_draft(1)
    assert draft.cfg.layers == 1 and len(draft.model.transformer.h) == 1
    # no weight copied: the draft's modules are the target's
    assert draft.model.transformer.h[0] is gen.model.transformer.h[0]
    assert draft.model.predict_token is gen.model.predict_token
    want, want_rounds = jgen.generate_spec_draft(ex, jgen.truncated_draft(1), **kw)
    got, rounds = gen.generate_spec_draft(ex, draft, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, _plain(gen, [ex], 12)[0])
    assert rounds == want_rounds
    assert len(gen.model.transformer.h) == 2  # the target keeps its blocks
    with pytest.raises(ValueError, match="n_layers"):
        gen.truncated_draft(2)


def test_refusals(tgt):
    _, gen = tgt
    text = _text(gen)
    with pytest.raises(ValueError, match="token history"):
        gen.generate_spec({"images": np.zeros((1, 16, 16, 3), np.float32)},
                          max_new_tokens=4, **text)
    with pytest.raises(ValueError, match="overflow"):
        gen.generate_spec({"text": list(range(50))}, max_new_tokens=10, **text)
    _, other = _pair(1, embed_dim=32, layers=1, heads=2, context_len=64)
    other.cfg = dataclasses.replace(other.cfg, text_tokens=64)
    with pytest.raises(ValueError, match="token space"):
        gen.generate_spec_draft({"text": [1, 2]}, other, max_new_tokens=4, **text)
