"""The fused loss-head forward of neko_tpu_torch against neko_tpu on the CPU.

The plain version of kernel #15 (`fused_logz_tl` on a CPU tensor) against
neko_tpu's `fused_logz_tl` Pallas kernel in interpret mode (as
tests/test_loss_kernel.py runs it), with `valid_vocab` None and below V, on
one and on several row blocks, fp32 and bf16 operands.  The port takes the
head weight as torch holds it, [V, D]; the JAX kernel takes its transpose.
Tolerance 2e-5 absolute plus 1e-6 relative, the JAX test's own: both sides
accumulate the same bf16-exact products in fp32, in another order.  Also
`_pick_vb` against neko_tpu's, and the plain (logz, target logit) against
the per-row NLL of the port's loss.

The CUDA kernel against the plain version is in test_torch_kernels_cuda.py
(card only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops import loss_kernel as jax_lk  # noqa: E402

from neko_tpu_torch.ops import loss_kernel as lk  # noqa: E402
from neko_tpu_torch.ops import losses  # noqa: E402

TOL = dict(atol=2e-5, rtol=1e-6)


@pytest.mark.parametrize("V", [52480, 2560, 1280, 127, 128, 1536, 3000, 4096 * 3])
def test_pick_vb_matches_jax(V):
    assert lk._pick_vb(V) == jax_lk._pick_vb(V)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,D,V,valid_vocab", [
    (1024, 256, 2560, None), (1024, 256, 2560, 2000),  # one row block
    (2048, 128, 1280, None), (2048, 128, 1280, 1100),  # two row blocks
])
def test_plain_matches_jax_kernel(N, D, V, valid_vocab, dtype):
    rng = np.random.default_rng(N + V + (valid_vocab or 0))
    x = rng.standard_normal((N, D)).astype(np.float32)
    W = (rng.standard_normal((V, D)) * 0.05).astype(np.float32)
    t = rng.integers(0, valid_vocab or V, N).astype(np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want_logz, want_tl = jax_lk.fused_logz_tl(jnp.asarray(x, jd), jnp.asarray(t),
                                              jnp.asarray(W.T, jd), valid_vocab=valid_vocab)
    logz, tl = lk.fused_logz_tl(torch.from_numpy(x).to(td), torch.from_numpy(t),
                                torch.from_numpy(W).to(td), valid_vocab)
    assert logz.dtype == tl.dtype == torch.float32 and logz.shape == tl.shape == (N,)
    np.testing.assert_allclose(logz.numpy(), np.asarray(want_logz), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(want_tl), **TOL)


def test_fused_supported():
    assert lk.fused_supported(4096, 768, 52480)
    assert lk.fused_supported(3328, 768, 52480)  # any N (the TPU kernel: N % 256 == 0)
    assert lk.fused_supported(100, 64, 1000)     # any V: a ragged tile is masked
    assert not lk.fused_supported(4096, 768, 52480, torch.float32)
    assert not lk.fused_supported(4096, 100, 52480)  # D is walked in steps of 32


def test_plain_is_the_loss_forward():
    """sum over rows of logz - target logit is the port's chunk NLL."""
    rng = np.random.default_rng(4)
    N, D, V, valid = 300, 64, 700, 650
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    W = torch.from_numpy((rng.standard_normal((V, D)) * 0.1).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, valid, N))
    m = torch.ones(N)
    logz, tl = lk.fused_logz_tl(x, t, W, valid)
    nll = losses._ChunkNLL.apply(x, t, m, W, valid)
    torch.testing.assert_close((logz - tl).sum(), nll, rtol=1e-6, atol=1e-4)
