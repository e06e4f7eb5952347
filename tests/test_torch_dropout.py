"""Dropout and the GELU backward of neko_tpu_torch against neko_tpu (CPU).

The two packages draw different random bits, so dropout is compared by its
semantics: the threshold round(rate * 256), the survivor scale
1 / (1 - q / 256), the keep share within binomial bounds, the kept mean.
The GELU derivative (saved in the forward) is held to `jax.vjp` of
neko_tpu.ops.gelu.gelu_erf within 1e-6."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops.dropout import materialized_dropout as jax_dropout  # noqa: E402
from neko_tpu.ops.gelu import gelu_erf as jax_gelu  # noqa: E402

from neko_tpu_torch.ops.dropout import Dropout, keep_threshold, materialized_dropout  # noqa: E402
from neko_tpu_torch.ops.gelu import gelu_erf  # noqa: E402

N = 1 << 18


def _stats(y: np.ndarray):
    kept = y != 0
    return kept.mean(), np.unique(y[kept])


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_dropout_threshold_scale_and_keep_share_match_jax(rate):
    q = keep_threshold(rate)
    assert q == int(round(rate * 256))
    p = 1.0 - q / 256.0
    bound = 5.0 * np.sqrt(p * (1 - p) / N)
    g = torch.Generator().manual_seed(0)
    got = materialized_dropout(torch.ones(N), rate, g).numpy()
    want = np.asarray(jax_dropout(jax.random.key(0), jnp.ones(N), rate))
    for y in (got, want):
        share, values = _stats(y)
        assert abs(share - p) < bound
        # one survivor value: the realized-keep scale, identical in fp32
        np.testing.assert_array_equal(values, np.float32(1.0 / p))
        # E[dropout(x)] == x
        assert abs(y.mean() - 1.0) < bound / p


def test_dropout_identity_and_errors():
    x = torch.randn(64)
    g = torch.Generator().manual_seed(1)
    assert materialized_dropout(x, 0.0, g) is x
    assert materialized_dropout(x, 0.001, g) is x  # rounds to q = 0
    assert materialized_dropout(x, 0.5, None) is x  # no generator: deterministic
    assert Dropout(0.3)(x) is x
    with pytest.raises(ValueError):
        materialized_dropout(x, 0.999, g)  # rounds to 256: drops everything
    with pytest.raises(AssertionError):
        jax_dropout(jax.random.key(0), jnp.ones(4), 0.999)


def test_dropout_keeps_x_and_its_gradient_on_the_same_elements():
    x = torch.randn(4096, requires_grad=True)
    y = materialized_dropout(x, 0.25, torch.Generator().manual_seed(2))
    y.backward(torch.ones_like(y))
    kept = y.detach() != 0
    scale = 1.0 / (1.0 - 64 / 256)
    torch.testing.assert_close(y.detach()[kept], x.detach()[kept] * scale)
    torch.testing.assert_close(x.grad, kept.float() * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_gelu_backward_matches_jax_vjp(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(8192).astype(np.float32) * 4
    g = rng.standard_normal(8192).astype(np.float32)
    _, vjp = jax.vjp(jax_gelu, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    gelu_erf(xt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the forward under autograd is the serving forward
    np.testing.assert_allclose(gelu_erf(xt).detach().numpy(),
                               gelu_erf(torch.from_numpy(x)).numpy(), rtol=1e-6, atol=1e-7)


def test_gelu_bf16_backward_keeps_the_dtype():
    x = torch.randn(256).bfloat16().requires_grad_()
    y = gelu_erf(x)
    y.sum().backward()
    assert y.dtype == torch.bfloat16 and x.grad.dtype == torch.bfloat16
