"""Decode-step cache attention in neko_tpu_torch against neko_tpu on the CPU.

* The plain version of kernel #14 (`decode_cache_attention` on a CPU tensor)
  against neko_tpu's `decode_cache_attention` Pallas kernel in interpret
  mode (as tests/test_decode_attention.py runs it), on rows with a full
  cache, a left-padded `start`, and a single valid key (index == start).
  Tolerance: fp32 2e-5 absolute (summation order, as the JAX test's own);
  bf16 1e-2 absolute plus one bf16 ulp relative: both outputs are rounded to
  bf16, and the TPU kernel also rounds q * sm_scale to bf16 before the score
  product, which the port does not.
* The decode step of the port's model: the window [start, end) it hands the
  kernel wrapper, once per step, before and after the ring over the cache
  wraps, and greedy generation with the wrap against neko_tpu's generator
  at converted weights (fp32): the same tokens, window logits within 1e-4.

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
from neko_tpu.inference import generator as jax_generator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.ops import decode_attention as jax_da  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.ops import attention as attn_ops  # noqa: E402
from neko_tpu_torch.ops import decode_attention as da  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=1e-2, rtol=2.0 ** -7)}


def _inputs(B, H, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, hd), (B, H, S, hd), (B, H, S, hd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("H,S", [(8, 128), (24, 256)])
def test_plain_matches_jax_kernel(H, S, hd, dtype):
    q, k, v = _inputs(4, H, S, hd, seed=hd + S)
    # rows: a full cache, a left-padded start, one valid key, a short window
    start = np.array([0, S // 3, 57, 0], np.int32)
    index = np.array([S - 1, S - 1, 57, 9], np.int32)  # newest row, inclusive
    jd = getattr(jnp, dtype)
    want, kc, vc = jax_da.decode_cache_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(index), jnp.asarray(start))
    td = getattr(torch, dtype)
    qt, kt, vt = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = da.decode_cache_attention(qt, kt, vt, torch.from_numpy(start),
                                    torch.from_numpy(index + 1))
    assert got.dtype == td and got.shape == (4, H, hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    # the JAX kernel passes the caches through; the port's never writes them
    np.testing.assert_array_equal(kt.float().numpy(), np.asarray(kc.astype(jnp.float32)))
    np.testing.assert_array_equal(vt.float().numpy(), np.asarray(vc.astype(jnp.float32)))


def test_single_key_and_empty_rows():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 8, 128, 32, seed=1))
    start = torch.tensor([7, 50, 128], dtype=torch.int32)
    end = torch.tensor([8, 50, 0], dtype=torch.int32)  # one key; two empty windows
    out = da.decode_cache_attention(q, k, v, start, end)
    torch.testing.assert_close(out[0], v[0, :, 7], atol=1e-6, rtol=0)
    assert torch.equal(out[1:], torch.zeros_like(out[1:]))  # zeros, never NaN


def test_supported():
    assert da.supported(8, 24, 1024, 32)
    assert da.supported(8, 24, 1000, 32)   # any S (the TPU kernel needs S % 128 == 0)
    assert da.supported(1, 8, 16384, 128)  # no VMEM cap
    assert da.supported(8, 24, 1024, 48)   # padded to a compiled width
    assert not da.supported(8, 24, 1024, 256)
    assert not jax_da.supported(8, 24, 1000, 32)


TINY = dict(embed_dim=64, layers=2, heads=2, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64, discrete_tokens=64)


@pytest.fixture(scope="module")
def gens():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(5)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    jgen = jax_generator.Generator(jmodel, params, JaxPacker(jcfg), seed=0)
    return jgen, Generator(convert.build_model(cfg, sd, device="cpu"), seed=0)


def test_generation_through_the_decode_wrapper_wraps_the_ring_as_jax(gens, monkeypatch):
    """Prompts of 60, 12 and 50 tokens plus 14 new tokens overflow the
    64-row cache: the first row's window grows to [0, 64) and stays there
    after its writes wrap to row 0; the other rows' windows are [0, pos]."""
    jgen, gen = gens
    rng = np.random.default_rng(21)
    lens = (60, 12, 50)
    examples = [{"text": rng.integers(0, 256, n)} for n in lens]
    windows = []
    wrapper = attn_ops.decode_attention

    def spy(q, k, v, start, end, key_mask):
        windows.append((start.tolist(), end.tolist()))
        return wrapper(q, k, v, start, end, key_mask)

    monkeypatch.setattr(attn_ops, "decode_attention", spy)
    kw = dict(max_new_tokens=14, start=0, end=255)
    got_t, got_w = gen.generate_batch(examples, **kw)
    want_t, want_w = jgen.generate_batch(examples, **kw)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_w, want_w, rtol=1e-4, atol=1e-4)

    S, L = TINY["context_len"], TINY["layers"]
    steps = kw["max_new_tokens"] - 1
    assert len(windows) == L * steps  # one call a layer and a step
    per_step = windows[::L]
    assert all(w == per_step[i // L] for i, w in enumerate(windows))  # one window a step
    for i, (start, end) in enumerate(per_step):
        # the packed prompt holds each example's tokens and a separator
        pos = [n + 1 + i for n in lens]
        assert start == [0, 0, 0]
        assert end == [min(p + 1, S) for p in pos], (i, end)
    assert per_step[-1][1][0] == S and lens[0] + 1 + steps > S  # row 0 wrapped


def test_decode_step_with_holes_in_the_cache_mask_matches_jax(gens):
    """A cache mask with holes inside its valid run (rows a left-padded
    prompt or an eviction clears): the decode step attends to the valid rows
    alone, as neko_tpu's decode step does through its mask bias.  The window
    [start, end) spans the holes; the kernel's plain version skips them."""
    jgen, gen = gens
    jmodel, params, model = jgen.model, jgen.params, gen.model
    rng = np.random.default_rng(5)
    arrays = JaxPacker(JaxConfig(**TINY)).pack_batch(
        [{"text": rng.integers(0, 256, 40)}, {"text": rng.integers(0, 256, 25)}])
    lengths = arrays.pop("lengths")
    emb = np.array(jmodel.apply({"params": params}, jax_batch(arrays),
                                method=JaxModel.embed_batch))
    mask = arrays["input_mask"]
    _, vars_ = jmodel.apply({"params": params}, jnp.asarray(emb), jnp.asarray(mask),
                            method=JaxModel.prefill, mutable=["cache"])
    with torch.no_grad():
        _, caches = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    first = mask.argmax(1)  # each row's valid run starts here
    holes = np.zeros_like(mask)
    holes[0, first[0] + np.array([3, 4, 5, 20])] = True  # inside the valid runs
    holes[1, first[1] + 10:first[1] + 18] = True
    assert mask[holes].all()
    jcache = jax.tree_util.tree_map_with_path(
        lambda path, x: x & ~jnp.asarray(holes) if path[-1].key == "mask" else x,
        vars_["cache"])
    for c in caches:
        c["mask"][torch.from_numpy(holes)] = False
    pos = lengths.astype(np.int32)
    tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
    e = np.array(jmodel.apply({"params": params}, jnp.asarray(tok),
                              method=JaxModel.embed_tokens))
    want, _ = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(e),
                           jnp.asarray(pos), method=JaxModel.decode_step, mutable=["cache"])
    with torch.no_grad():
        got = model.decode_step(torch.from_numpy(e), torch.from_numpy(pos), caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_plain_decode_skips_masked_rows_inside_the_window():
    """The plain version over a window with holes equals attention over the
    valid rows alone, and a window whose rows are all masked gives 0."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 4, 64, 32, seed=9))
    mask = torch.zeros(2, 64, dtype=torch.bool)
    keep = [2, 7, 30, 31, 50]
    mask[0, keep] = True
    start = torch.tensor([2, 10], dtype=torch.int32)
    end = torch.tensor([51, 20], dtype=torch.int32)  # row 1: no valid row in its window
    out = da.decode_cache_attention(q, k, v, start, end, mask)
    want = da.decode_cache_attention_reference(
        q[:1], k[:1, :, keep], v[:1, :, keep], torch.tensor([0], dtype=torch.int32),
        torch.tensor([len(keep)], dtype=torch.int32))
    torch.testing.assert_close(out[:1], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
