"""Attention in neko_tpu_torch against neko_tpu on the CPU.

The TPU kernel (neko_tpu/ops/attention_kernel.py::whole_head_attention) has
no interpret mode, so its CPU oracle is the JAX package's `xla_attention`
(the path neko_tpu itself runs on the CPU); the two agree on every query row
that has at least one valid key.  The CUDA kernel against the plain version
lives in test_torch_attention_cuda.py, which runs on the card only."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops import attention as jax_attn  # noqa: E402
from neko_tpu.ops import attention_kernel as jax_whk  # noqa: E402
from neko_tpu.ops.gelu import gelu_erf as jax_gelu  # noqa: E402

from neko_tpu_torch.ops import attention as attn  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops.gelu import gelu_erf  # noqa: E402

B, H, S, HD = 3, 2, 48, 16


def _qkv(seed, hd=HD, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, S, hd)).astype(dtype) for _ in range(3)]


def _mask(kind):
    m = np.zeros((B, S), bool)
    if kind == "left":
        for b, n in enumerate((S, 30, 5)):
            m[b, S - n:] = True
    elif kind == "right":
        for b, n in enumerate((S, 17, 1)):
            m[b, :n] = True
    else:
        m[:] = True
    return m


def _valid_rows(m):
    """[B, S]: query row r sees some key (start <= r and start < end)."""
    rows = np.arange(S)[None, :]
    start = np.where(m.any(1), m.argmax(1), S)[:, None]
    return (rows >= start) & m.any(1)[:, None]


@pytest.mark.parametrize("kind", ["left", "right", "full"])
def test_plain_whole_head_matches_jax_xla_attention(kind):
    q, k, v = _qkv(1)
    m = _mask(kind)
    want = np.asarray(jax_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m)))
    start, end = whk.mask_bounds_from_key_mask(torch.from_numpy(m))
    got = whk.whole_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), start, end
    ).numpy()
    ok = _valid_rows(m)
    np.testing.assert_allclose(
        got.transpose(0, 2, 1, 3)[ok], want.transpose(0, 2, 1, 3)[ok], atol=1e-5)
    # rows with no visible key are exact zeros, never NaN
    assert np.all(got.transpose(0, 2, 1, 3)[~ok] == 0)


@pytest.mark.parametrize("kind", ["left", "right"])
def test_port_xla_attention_matches_jax_on_every_row(kind):
    q, k, v = _qkv(2)
    m = _mask(kind)
    want = np.asarray(jax_attn.xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m)))
    got = attn.xla_attention(*(torch.from_numpy(a) for a in (q, k, v, m))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_prefill_attention_is_the_whole_head_wrapper():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3))
    m = torch.from_numpy(_mask("right"))
    start, end = whk.mask_bounds_from_key_mask(m)
    before = whk.whole_head_attention.launches
    out = attn.prefill_attention(q, k, v, m)
    torch.testing.assert_close(
        out, whk.whole_head_attention_reference(q, k, v, start, end),
        rtol=0, atol=0)
    assert whk.whole_head_attention.launches == before  # CPU: no kernel launch


def test_empty_key_sets_give_zero_rows():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4))
    start = torch.tensor([5, 10, 0], dtype=torch.int32)
    end = torch.tensor([S, 10, 0], dtype=torch.int32)  # rows 1, 2: no keys at all
    out = whk.whole_head_attention(q, k, v, start, end)
    assert torch.isfinite(out).all()
    assert torch.all(out[0, :, :5] == 0) and torch.all(out[1:] == 0)
    assert torch.all(out[0, :, 5:].abs().sum(-1) > 0)


@pytest.mark.parametrize("case", ["left", "right", "full", "empty_row", "gap_free_middle"])
def test_mask_bounds_match_jax(case):
    m = np.zeros((B, S), bool) if case == "empty_row" else _mask(
        {"gap_free_middle": "full"}.get(case, case))
    if case == "empty_row":
        m[0, 3:9] = True  # rows 1 and 2 stay all False
    if case == "gap_free_middle":
        m[:] = False
        m[0, 10:20] = True
        m[1, 0] = True
        m[2, S - 1] = True
    want = jax_whk.mask_bounds_from_key_mask(jnp.asarray(m))
    got = whk.mask_bounds_from_key_mask(torch.from_numpy(m))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gelu_matches_jax():
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32) * 4
    np.testing.assert_allclose(
        gelu_erf(torch.from_numpy(x)).numpy(), np.asarray(jax_gelu(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)
    assert gelu_erf(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def _good_args():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, hd=32))
    start = torch.zeros(B, dtype=torch.int32)
    end = torch.full((B,), S, dtype=torch.int32)
    return [q, k, v, start, end]


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "head_dim", "shape",
                                 "contiguity", "bounds_dtype", "bounds_shape"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = _good_args()
    whk._check_kernel_args(*args)  # the good case passes
    q = args[0]
    if bad == "dtype":
        args[:3] = [t.half() for t in args[:3]]
    elif bad == "mixed_dtype":
        args[1] = args[1].bfloat16()
    elif bad == "head_dim":
        args[:3] = [t[..., :16].contiguous() for t in args[:3]]
    elif bad == "shape":
        args[2] = args[2][:, :, :-1]
    elif bad == "contiguity":  # strided views are taken; hd must be contiguous
        args[0] = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "bounds_dtype":
        args[3] = args[3].long()
    elif bad == "bounds_shape":
        args[4] = args[4][:-1]
    with pytest.raises(ValueError):
        whk._check_kernel_args(*args)


def test_dropout_and_unsupported_devices_raise():
    q, k, v, start, end = _good_args()
    with pytest.raises(ValueError):  # dropout needs a seed, as in neko_tpu
        whk.whole_head_attention(q, k, v, start, end, dropout_rate=0.1)
    seed = torch.tensor([1], dtype=torch.int32)
    out = whk.whole_head_attention(q, k, v, start, end, seed, dropout_rate=0.1)
    assert torch.isfinite(out).all()
    with pytest.raises(ValueError):
        whk.whole_head_attention(*(t.to("meta") for t in (q, k, v, start, end)))
    assert whk.supported(1024, 32, torch.bfloat16)
    assert whk.supported(2048, 128, torch.float32)
    assert whk.supported(1024, 16, torch.float32)  # padded to a compiled width
    assert not whk.supported(1024, 256, torch.float32)
    assert not whk.supported(1024, 64, torch.float16)
