"""Beam search of neko_tpu_torch (`Generator.generate_beam` and the
`predict_*` calls with `num_beams > 1`) against neko_tpu's on the CPU, at
converted weights (32d, 2 layers, 2 heads, k = 48, fp32), the cases of
tests/test_beam.py:

* tokens identical, scores and the window logits along each beam within
  rtol 1e-5 (atol 1e-5 for values near 0): one beam (= greedy), the full
  16-token discrete window over 2 steps (exhaustive), 3 beams over 4 steps,
  two prompts in one batch, inner positions continued after a dropped
  trailing token;
* `predict_text` / `predict_caption` / `predict_answer` /
  `predict_response` with `num_beams > 1`: ids identical, logits within
  atol 1e-5;
* ties in the top `num_beams` break toward the lower index, as
  `jax.lax.top_k` breaks them (a hand-made tie);
* `num_beams` wider than the window and context overflow raise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402

TINY = dict(embed_dim=32, layers=2, heads=2, dropout=0.0, context_len=48, max_patches=4,
            patch_size=16, dtype="float32", text_tokens=128, continuous_tokens=32,
            discrete_tokens=16)
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT = {"text": [5, 9, 2, 77]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gens():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(0)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return (JaxGenerator(jmodel, params, JaxPacker(jcfg), seed=3),
            Generator(convert.build_model(cfg, sd, device="cpu"), seed=3))


def _window(gen, kind):
    ts = gen.cfg.token_space
    return ts.start(kind), ts.end(kind)


CASES = {
    # (examples, window, steps, beams, extra kwargs)
    "one_beam": ([PROMPT], "text", 5, 1, {}),
    "exhaustive": ([PROMPT], "discrete", 2, 16, {}),
    "three_beams": ([PROMPT], "discrete", 4, 3, {}),
    "batched": ([{"text": [4, 4, 8]}, {"text": [100, 3]}], "text", 3, 3, {}),
    "inner_pos": ([{"images": np.full((1, 32, 32, 3), 128, np.float32), "text": [7, 1]}],
                  "text", 3, 2, dict(drop_trailing=1, inner_pos_continuation=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_beam_matches_jax(gens, case):
    jgen, gen = gens
    examples, kind, T, B, kw = CASES[case]
    start, end = _window(gen, kind)
    args = dict(max_new_tokens=T, start=start, end=end, num_beams=B, return_logits=True, **kw)
    want = jgen.generate_beam(examples, **args)
    got = gen.generate_beam(examples, **args)
    assert got[0].shape == (len(examples), B, T) and got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **TOL)
    assert (np.diff(got[1], axis=1) <= 1e-6).all()  # beam 0 is the best


def test_one_beam_is_greedy(gens):
    _, gen = gens
    start, end = _window(gen, "text")
    greedy, _ = gen.generate_batch([PROMPT], max_new_tokens=5, start=start, end=end)
    beams, scores = gen.generate_beam([PROMPT], max_new_tokens=5, start=start, end=end,
                                      num_beams=1)
    np.testing.assert_array_equal(beams[0, 0], greedy[0])
    assert scores.shape == (1, 1)


@pytest.mark.parametrize("call", ["text", "caption", "answer", "response"])
def test_predict_calls_with_beams_match_jax(gens, call):
    jgen, gen = gens
    img = np.random.RandomState(1).randint(0, 256, (1, 32, 32, 3)).astype(np.float32)
    name, args, kw = {
        "text": ("predict_text", (PROMPT,), dict(max_length=4, num_beams=3)),
        "caption": ("predict_caption", (img,), dict(max_length=3, num_beams=2)),
        "answer": ("predict_answer", (img, [10, 11]), dict(max_length=3, num_beams=4)),
        "response": ("predict_response", (img, [12]), dict(max_length=2, num_beams=2)),
    }[call]
    want_logits, want_ids = getattr(jgen, name)(*args, **kw)
    got_logits, got_ids = getattr(gen, name)(*args, **kw)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(got_logits, np.asarray(want_logits), rtol=0, atol=1e-5)


def test_ties_break_toward_the_lower_index(gens):
    """Equal logits everywhere: every candidate ties, and the beams must be
    the lowest (parent, token) indices, as jax.lax.top_k orders them."""
    _, gen = gens
    start, end = _window(gen, "discrete")
    model = gen.model
    head = model.predict_token.weight.detach().clone()
    try:
        with torch.no_grad():
            model.predict_token.weight.zero_()
        toks, scores = gen.generate_beam([PROMPT], max_new_tokens=2, start=start, end=end,
                                         num_beams=3)
    finally:
        with torch.no_grad():
            model.predict_token.weight.copy_(head)
    # step 0: beam 0 alone is live -> tokens 0, 1, 2; step 1: parent 0's
    # tokens 0, 1, 2 outrank (tie) everything after them
    assert (toks[0] - start).tolist() == [[0, 0], [0, 1], [0, 2]]
    np.testing.assert_allclose(scores[0], 2 * -np.log(16.0), rtol=1e-6)


def test_beam_refusals(gens):
    _, gen = gens
    start, end = _window(gen, "discrete")
    with pytest.raises(ValueError, match="num_beams"):
        gen.generate_beam([PROMPT], max_new_tokens=2, start=start, end=end, num_beams=17)
    with pytest.raises(ValueError, match="overflow"):
        gen.generate_beam([{"text": list(range(40))}], max_new_tokens=10, start=start,
                          end=end, num_beams=2)
