"""neko_tpu_torch host code against neko_tpu: config sizes, the continuous
tokenizer and the sequence packer must agree bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.tokenizers import continuous as jax_cont  # noqa: E402

from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.data.packing import SequencePacker  # noqa: E402
from neko_tpu_torch.tokenizers import continuous as port_cont  # noqa: E402

TINY = dict(embed_dim=64, layers=2, heads=4, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64)


def _example(kind: str, rng: np.random.Generator) -> dict:
    if kind == "text":
        return {"text": rng.integers(0, 256, 20)}
    if kind == "long_text":  # cut to S - 1 tokens + separator
        return {"text": rng.integers(0, 256, 100)}
    if kind == "continuous":
        return {"continuous_obs": rng.standard_normal((3, 5)).astype(np.float32),
                "continuous_actions": rng.uniform(-1, 1, (3, 2)).astype(np.float32)}
    if kind == "discrete":
        return {"discrete_obs": rng.integers(0, 64, (4, 2)),
                "discrete_actions": rng.integers(0, 64, (4, 1))}
    if kind == "image":
        return {"images": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                "discrete_actions": rng.integers(0, 18, (2, 1))}
    if kind == "overflow":  # 30 timesteps of 8 tokens: oldest ones dropped
        return {"continuous_obs": rng.standard_normal((30, 5)).astype(np.float32),
                "continuous_actions": rng.uniform(-1, 1, (30, 2)).astype(np.float32)}
    raise AssertionError(kind)


KINDS = ["text", "long_text", "continuous", "discrete", "image", "overflow"]


@pytest.mark.parametrize("pad_side", ["left", "right"])
@pytest.mark.parametrize("kind", KINDS + ["mixed"])
def test_pack_batch_matches_neko_tpu(kind, pad_side):
    rng = np.random.default_rng(KINDS.index(kind) if kind in KINDS else 99)
    kinds = ["text", "continuous", "discrete", "image"] if kind == "mixed" else [kind, kind]
    examples = [_example(k, rng) for k in kinds]
    want = JaxPacker(JaxConfig(**TINY)).pack_batch(examples, pad_side=pad_side)
    got = SequencePacker(ModelConfig(**TINY)).pack_batch(examples, pad_side=pad_side)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_to_device_batch_keeps_arrays():
    rng = np.random.default_rng(0)
    arrays = SequencePacker(ModelConfig(**TINY)).pack_batch(
        [_example("image", rng), _example("text", rng)])
    batch = to_device_batch(arrays, "cpu")
    assert batch.has_patches and batch.tokens.shape == (2, 64)
    np.testing.assert_array_equal(batch.patches.numpy(), arrays["patches"])
    np.testing.assert_array_equal(batch.tokens.numpy(), arrays["tokens"])


@pytest.mark.parametrize("fn", ["encode_mu", "encode_plain", "encode_clip",
                                "decode", "decode_mu_law"])
def test_continuous_tokenizer_bit_identical(fn):
    rng = np.random.default_rng(3)
    # exact +-1.0 and 0.0 exercise the unclipped top bin and the edges
    x = np.concatenate([rng.standard_normal(500) * 3,
                        [1.0, -1.0, 0.0, 1e-7]]).astype(np.float32)
    t = rng.integers(0, 1024, 500)
    calls = {
        "encode_mu": lambda m: m.encode_np(x, use_mu_law=True, offset=7),
        "encode_plain": lambda m: m.encode_np(x, use_mu_law=False, n_bins=64),
        "encode_clip": lambda m: m.encode_np(x, use_mu_law=False, clip_bins=True),
        "decode": lambda m: m.decode_np(t, offset=3),
        "decode_mu_law": lambda m: m.decode_mu_law_np(t, mu=50, M=128),
    }
    got, want = calls[fn](port_cont), calls[fn](jax_cont)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, TINY])
def test_config_sizes_match_neko_tpu(kw):
    got, want = ModelConfig(**kw), JaxConfig(**kw)
    for name in ("vocab_size", "padded_vocab_size", "padded_embed_rows", "head_dim"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.token_space == type(got.token_space)(**{
        f: getattr(want.token_space, f)
        for f in ("text_tokens", "continuous_tokens", "discrete_tokens")})
    import dataclasses
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert got.activation_dtype == getattr(torch, got.dtype)
