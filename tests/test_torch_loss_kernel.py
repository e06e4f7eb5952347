"""The fused loss-head forward of neko_tpu_torch against neko_tpu on the CPU.

The plain version of kernel #15 (`fused_logz_tl` on a CPU tensor) against
neko_tpu's `fused_logz_tl` Pallas kernel in interpret mode (as
tests/test_loss_kernel.py runs it), with `valid_vocab` None and below V, on
one and on several row blocks, fp32 and bf16 operands.  The port takes the
head weight as torch holds it, [V, D]; the JAX kernel takes its transpose.
Tolerance 2e-5 absolute plus 1e-6 relative, the JAX test's own: both sides
accumulate the same bf16-exact products in fp32, in another order.  Also
`_pick_vb` against neko_tpu's, the plain (logz, target logit) against the
per-row NLL of the port's loss, the loss forward's route through
`fused_logz_tl` (for every shape `fused_supported` takes), and the chunk
NLL's value and gradients in bf16 against neko_tpu's `_chunk_nll` under
`jax.value_and_grad`.

The CUDA kernel against the plain version is in test_torch_kernels_cuda.py
(card only)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops import loss_kernel as jax_lk  # noqa: E402
from neko_tpu.ops import losses as jax_losses  # noqa: E402

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
    assert not lk.fused_supported(4096, 100, 52480)  # TMA: rows of whole 16-byte units


@pytest.mark.parametrize("D,dtype,ok", [
    (96, torch.bfloat16, True),     # a ragged last 64-deep slice: TMA reads zeros past D
    (8, torch.bfloat16, True),
    (100, torch.bfloat16, False),   # 200-byte rows: no 16-byte pitch
    (96, torch.float32, False),     # the tensor cores take bf16 here
    (768, torch.float32, False),
])
def test_fused_supported_gate(D, dtype, ok):
    assert lk.fused_supported(333, D, 1000, dtype) is ok


@pytest.mark.parametrize("dtype,routed", [(torch.bfloat16, True), (torch.float32, False)])
def test_loss_forward_routes_through_the_fused_head(monkeypatch, dtype, routed):
    """The loss forward takes (logz, target logit) from
    `loss_kernel.fused_logz_tl` for every shape `fused_supported` takes (on
    the card kernel #15); fp32 hidden keeps the logits route.  Either way
    the NLL is the same."""
    calls = []
    fused = lk.fused_logz_tl

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return fused(*args, **kw)

    monkeypatch.setattr(lk, "fused_logz_tl", counted)
    rng = np.random.default_rng(7)
    N, D, V, valid = 300, 96, 700, 650
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(dtype)
    W = torch.from_numpy((rng.standard_normal((V, D)) * 0.1).astype(np.float32)).to(dtype)
    t = torch.from_numpy(rng.integers(0, valid, N))
    m = torch.ones(N)
    nll = losses._ChunkNLL.apply(x, t, m, W, valid)
    assert calls == ([(N, D)] if routed else [])
    logz, tl = lk.fused_logz_tl_reference(x, t, W, valid)
    torch.testing.assert_close(nll, (logz - tl).sum(), rtol=1e-6, atol=1e-4)


def test_chunk_nll_bf16_value_and_grads_match_jax():
    """The chunk NLL through the routed forward, in bf16 with valid_vocab < V
    and N = 300 (no multiple of 128), against neko_tpu's `_chunk_nll` under
    `jax.value_and_grad` on the same bf16 values.  Value: both sides sum
    fp32 logits of exact bf16 products, in other orders (1e-5 relative).
    Gradients: both round dlogits to bf16 from fp32 values computed in other
    orders, and a flipped rounding moves a gradient by one ulp of a dlogit
    times an operand; dx and dW round to bf16 (one bf16 ulp relative,
    5e-4 absolute, as the port's chunked-loss test holds them)."""
    rng = np.random.default_rng(12)
    N, D, V, valid = 300, 96, 1000, 990
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).bfloat16()
    W = torch.from_numpy((rng.standard_normal((V, D)) * 0.3).astype(np.float32)).bfloat16()
    t = torch.from_numpy(rng.integers(0, valid, N))
    m = torch.from_numpy((rng.random(N) < 0.8).astype(np.float32))

    def jax_nll(xj, wj):
        return jax_losses._chunk_nll(xj, jnp.asarray(t.numpy().astype(np.int32)),
                                     jnp.asarray(m.numpy()), wj, valid)

    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    wj = jnp.asarray(W.float().numpy().T, jnp.bfloat16)
    want, (dx_w, dw_w) = jax.value_and_grad(jax_nll, argnums=(0, 1))(xj, wj)
    xg, Wg = x.clone().requires_grad_(), W.clone().requires_grad_()
    got = losses._ChunkNLL.apply(xg, t, m, Wg, valid)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    np.testing.assert_allclose(xg.grad.float().numpy(), np.asarray(dx_w.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=5e-4)
    np.testing.assert_allclose(Wg.grad.float().numpy().T, np.asarray(dw_w.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=5e-4)


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
