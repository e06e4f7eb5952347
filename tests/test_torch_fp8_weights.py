"""fp8 (e4m3) serving weights of neko_tpu_torch (inference/quant.py,
`Generator(weight_dtype='fp8')`) against neko_tpu's on the CPU at converted
weights (64d, 2 layers, 4 heads, k = 64, fp32; 32x32 images at 16-pixel
patches where an image embedder is asked for):

* `quantize_state_dict` against `quantize_weights`: the fp8 bytes equal bit
  for bit (compared as uint8) and the scales equal, leaf for leaf;
* eligibility: the names neko_tpu quantizes (with the image projection, a
  GEGLU gate, not LoRA's leaves, never an embedding table), `min_size`;
  `quantized_bytes` equal to neko_tpu's;
* generation with fp8 weights against neko_tpu's (text and an image
  prompt): tokens equal, logits within 1e-4; with the int8 cache too;
* fp8 with beams, prompt-lookup speculation, the continuous engine
  (tests/test_continuous.py:256) and `truncated_draft` (the draft sharing
  the target's quantized weights, tests/test_spec_draft.py:252), each
  against neko_tpu's; `set_params` quantizes what it loads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.inference import quant as jax_quant  # noqa: E402

from neko_tpu_torch.inference import quant  # noqa: E402

from tests.test_torch_kv_quant import LOGIT_ATOL, PROMPT, TINY, _text, pair, weights  # noqa: E402

IMAGE = dict(TINY, max_patches=4, patch_size=16)
QSD_LEAF = {"q8": "weight", "qscale": "qscale"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image_weights():
    return weights(IMAGE, seed=3)


@pytest.fixture(scope="module")
def gens(image_weights):
    return pair(*image_weights, IMAGE, weights="fp8")


def _jax_quantized(params, min_size=1024):
    """neko_tpu's quantized leaves as {state-dict key: numpy}, in the port's
    layout (a Dense kernel's [in, out] fp8 transposed to [out, in])."""
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(
            jax_quant.quantize_weights(params, min_size=min_size)):
        names = [str(getattr(k, "key", k)) for k in path]
        if names[-1] not in QSD_LEAF:
            continue
        mods = [n.replace("h_", "h.") if n.startswith("h_") else n for n in names[:-2]]
        key = ".".join(mods + [QSD_LEAF[names[-1]]])
        a = np.asarray(v)
        out[key] = a.view(np.uint8).T if names[-1] == "q8" else a
    return out


@pytest.mark.parametrize("min_size", [1024, 20_000])
def test_quantize_matches_jax_bit_for_bit(image_weights, min_size):
    params, sd = image_weights
    want = _jax_quantized(params, min_size)
    qsd = quant.quantize_state_dict(sd, min_size=min_size)
    got = {k: (t.view(torch.uint8).numpy() if t.dtype == quant.FP8 else t.numpy())
           for k, t in qsd.items() if t.dtype == quant.FP8 or k.endswith(".qscale")}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if min_size == 1024:  # the image projection, every block's four, the head
        assert "image_embedding.projection.weight" in got and "predict_token.weight" in got
    assert not any("embed_token" in k or "pos_embed" in k for k in got)
    # (quantized bytes, total bytes): neko_tpu's count
    jq = jax_quant.quantize_weights(params, min_size=min_size)
    assert quant.quantized_bytes(qsd) == tuple(int(x) for x in jax_quant.quantized_bytes(jq))


def test_eligibility_lora_and_geglu():
    """LoRA's leaves stay unquantized, GEGLU's gate is quantized, as
    neko_tpu decides (the same names)."""
    tiny = dict(TINY, lora_r=4, activation_fn="geglu")
    params, sd = weights(tiny, seed=4)
    want = _jax_quantized(params)
    qsd = quant.quantize_state_dict(sd)
    got = {k for k, t in qsd.items() if t.dtype == quant.FP8}
    assert got == {k for k in want if k.endswith(".weight")}
    assert any(k.endswith("mlp.gate.weight") for k in got)
    assert not any("lora" in k for k in got)


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("prompt", ["text", "image"])
def test_fp8_generation_matches_jax(image_weights, kv, prompt):
    jgen, gen = pair(*image_weights, IMAGE, kv=kv, weights="fp8")
    assert quant.is_quantized(gen.model)
    rng = np.random.default_rng(5)
    examples = [{"text": PROMPT}, {"text": [88, 2, 41]}]
    if prompt == "image":
        examples = [{"images": rng.integers(0, 256, (1, 32, 32, 3)).astype(np.uint8),
                     "text": [3, 4]}, {"text": PROMPT}]
    want_t, want_w = jgen.generate_batch(examples, max_new_tokens=10, **_text(gen))
    got_t, got_w = gen.generate_batch(examples, max_new_tokens=10, **_text(gen))
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_allclose(got_w, np.asarray(want_w), atol=LOGIT_ATOL, rtol=0)


def test_fp8_beams_and_lookup_match_jax(gens):
    jgen, gen = gens
    kw = dict(max_new_tokens=6, num_beams=3, return_logits=True, **_text(gen))
    want = jgen.generate_beam([{"text": PROMPT}], **kw)
    got = gen.generate_beam([{"text": PROMPT}], **kw)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=LOGIT_ATOL, rtol=0)
    prompt = {"text": [7, 3, 9, 7, 3, 9, 7, 3]}
    want, wrounds = jgen.generate_spec(prompt, max_new_tokens=10, speculate_k=3, **_text(gen))
    got, rounds = gen.generate_spec(prompt, max_new_tokens=10, speculate_k=3, **_text(gen))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rounds == int(wrounds)


def test_fp8_engine_matches_jax(gens):
    jgen, gen = gens
    s = _text(gen)
    det, one = np.ones(2, bool), np.ones(2, np.float32)

    def run(g, **rng):
        st = g.engine_init(2, speculate_k=2)
        st = g.engine_admit(st, 0, {"text": PROMPT})
        t1, st = g.engine_chunk(st, n_steps=3, det=det, temp=one, top_p=one, **s, **rng)
        st = g.engine_admit(st, 1, {"text": [9, 9, 2, 9, 9]})
        c, a, st = g.engine_spec_chunk(st, rounds=2, K=2, **s, **rng)
        t2, st = g.engine_chunk(st, n_steps=3, det=det, temp=one, top_p=one, **s, **rng)
        return np.asarray(t1), np.asarray(c), np.asarray(a), np.asarray(t2)

    want = run(jgen, rng=jax.random.key(0))
    got = run(gen, generator=torch.Generator().manual_seed(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_fp8_truncated_draft_shares_the_quantized_weights(gens):
    jgen, gen = gens
    draft = gen.truncated_draft(1)
    assert draft.model.transformer.h[0] is gen.model.transformer.h[0]
    assert draft.model.predict_token.weight.dtype == quant.FP8  # still the target's fp8
    jdraft = jgen.truncated_draft(1)
    kw = dict(max_new_tokens=8, speculate_k=3, **_text(gen))
    want, wrounds = jgen.generate_spec_draft({"text": PROMPT}, jdraft, **kw)
    got, rounds = gen.generate_spec_draft({"text": PROMPT}, draft, **kw)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert rounds == int(wrounds)


def test_fp8_set_params_quantizes_what_it_loads(image_weights):
    """set_params on an fp8 Generator: the state dict serve-cast and
    quantized, as a fresh fp8 Generator of those weights holds them."""
    _, sd = image_weights
    _, gen = pair(*image_weights, IMAGE, weights="fp8")
    moved = {k: v * 1.5 if v.is_floating_point() else v for k, v in sd.items()}
    gen.set_params(moved)
    want = quant.quantize_state_dict(moved)
    for k, t in gen.model.state_dict().items():
        w = want[k]
        assert torch.equal(t.view(torch.uint8) if t.dtype == quant.FP8 else t,
                           w.view(torch.uint8) if w.dtype == quant.FP8 else w), k
