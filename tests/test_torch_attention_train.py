"""The training attention of neko_tpu_torch against the TPU kernel's own math,
on the CPU.

`_attn_fwd_body`, `_attn_bwd_body` and `_blk_grads` in
neko_tpu/ops/attention_kernel.py are plain jnp: they run on the CPU outside
`pallas_call`.  The port's plain versions (what its wrappers run on a CPU
tensor, and what the CUDA kernels are held to on the card) are held to them
in fp32 within 1e-5 (summation order only), in the [B, H, S, hd], head-packed
[B, S, H*hd] and fused [B, S, 3*H*hd] layouts, at S = 128, 256 and 512 (the
JAX bodies cut 1, 2 and 4 causal bands), for left-padded, right-padded and
empty rows:

* dropout 0 through `_attn_fwd_body` / `_attn_bwd_body`;
* dropout 0.1 through the forward composition (`_mask`, `_softmax`, `_dot`)
  and `_blk_grads`, with the port's keep/scale matrix passed as `ks` (the
  TPU's hardware PRNG cannot be matched, so the mask is injected).

`do` is zero on rows that see no key: nothing in the model sends a gradient
there, and the TPU kernel writes a finite average on those rows where the
port writes 0.  The keep mask itself is tested for determinism, layout
independence, independence across heads and seeds, its keep share and its
exact scale."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops import attention_kernel as jax_whk  # noqa: E402

from neko_tpu_torch.ops import attention as attn  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402

B, H, HD = 2, 2, 32
TOL = dict(rtol=1e-5, atol=1e-5)  # fp32: summation order only
RATE = 0.1
SEED = 20240611


def _bounds(kind, S):
    """int32 start, end [B] for a mask kind (contiguous valid runs)."""
    if kind == "left":      # training: left-padded, one short row
        start, end = [0, S - 37], [S, S]
    elif kind == "right":   # prefill: right-padded
        start, end = [0, 0], [S, S // 3]
    else:                   # one row with no valid key at all
        start, end = [S // 2, S], [S, 0]
    return np.array(start, np.int32), np.array(end, np.int32)


def _inputs(S, kind, seed=0):
    rng = np.random.default_rng(seed + S)
    q, k, v, do = (rng.standard_normal((B, H, S, HD)).astype(np.float32) for _ in range(4))
    start, end = _bounds(kind, S)
    rows = np.arange(S)[None, :]
    valid = (rows >= start[:, None]) & (start < end)[:, None]  # [B, S]
    do = do * valid[:, None, :, None]
    return q, k, v, do, start, end, valid


def _jax_body_fwd_bwd(q, k, v, do, start, end):
    """_attn_fwd_body / _attn_bwd_body per (b, h), dropout 0."""
    sm = HD ** -0.5

    def one(q, k, v, do, st, en):
        o = jax_whk._attn_fwd_body(q, k, v, st, en, None, 0, 0, 1,
                                   sm_scale=sm, dropout_rate=0.0)
        g = jax_whk._attn_bwd_body(q, k, v, do, st, en, None, 0, 0, 1,
                                   sm_scale=sm, dropout_rate=0.0)
        return (o,) + tuple(g)

    f = jax.vmap(jax.vmap(one, in_axes=(0, 0, 0, 0, None, None)))
    return [np.asarray(t) for t in jax.jit(f)(q, k, v, do, start, end)]


def _jax_blk_with_mask(q, k, v, do, start, end, ks):
    """The forward composition and `_blk_grads` with an injected keep/scale."""
    sm = HD ** -0.5
    S = q.shape[-2]

    def one(q, k, v, do, st, en, ks):
        p = jax_whk._softmax(jax_whk._mask(jax_whk._dot(q, k.T) * sm, st, en, S))
        o = jax_whk._dot((p * ks).astype(q.dtype), v)
        g = jax_whk._blk_grads(q, do, k, v, st, en, 0, ks, sm_scale=sm, in_dtype=q.dtype)
        return (o,) + tuple(g)

    f = jax.vmap(jax.vmap(one, in_axes=(0, 0, 0, 0, None, None, 0)))
    return [np.asarray(t) for t in jax.jit(f)(q, k, v, do, start, end, ks)]


def _port_fwd_bwd(layout, q, k, v, do, start, end, seed, rate):
    """The port's wrapper in `layout` on CPU tensors, results as [B,H,S,hd]."""
    st, en = torch.from_numpy(start), torch.from_numpy(end)

    def packed(a):  # [B, H, S, hd] -> [B, S, H*hd]
        return torch.from_numpy(a).transpose(1, 2).reshape(B, -1, H * HD)

    def unpacked(t):
        return t.reshape(B, -1, H, HD).transpose(1, 2)

    if layout == "bhsd":
        src = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = whk.whole_head_attention(*src, st, en, seed, dropout_rate=rate)
        grads = torch.autograd.grad(out, src, torch.from_numpy(do))
    elif layout == "bsd":
        src = [packed(a).requires_grad_() for a in (q, k, v)]
        out = unpacked(whk.whole_head_attention_bsd(*src, st, en, seed, heads=H,
                                                    dropout_rate=rate))
        grads = [unpacked(g) for g in torch.autograd.grad(out, src, torch.from_numpy(do))]
    else:  # one [B, S, 3*H*hd] tensor
        qkv = torch.cat([packed(a) for a in (q, k, v)], dim=-1).requires_grad_()
        out = unpacked(whk.whole_head_attention_qkv(qkv, st, en, seed, heads=H,
                                                    dropout_rate=rate))
        (g,) = torch.autograd.grad(out, (qkv,), torch.from_numpy(do))
        grads = [unpacked(t) for t in g.chunk(3, dim=-1)]
    return [t.detach().numpy() for t in (out, *grads)]


def _check(got, want, valid):
    names = ("out", "dq", "dk", "dv")
    vr = valid[:, None, :, None] & np.ones((1, H, 1, HD), bool)
    for name, g, w in zip(names, got, want):
        if name == "out":  # rows with no key: port 0, TPU a finite average
            np.testing.assert_allclose(g[vr], w[vr], err_msg=name, **TOL)
            assert np.all(g[~vr] == 0), name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


@pytest.mark.parametrize("layout", ["bhsd", "bsd", "qkv"])
@pytest.mark.parametrize("S", [128, 256, 512])
@pytest.mark.parametrize("kind", ["left", "right", "empty_row"])
def test_attention_matches_tpu_kernel_bodies(layout, S, kind):
    q, k, v, do, start, end, valid = _inputs(S, kind)
    want = _jax_body_fwd_bwd(q, k, v, do, start, end)
    got = _port_fwd_bwd(layout, q, k, v, do, start, end, None, 0.0)
    _check(got, want, valid)


@pytest.mark.parametrize("layout", ["bhsd", "bsd", "qkv"])
@pytest.mark.parametrize("S", [128, 256, 512])
@pytest.mark.parametrize("kind", ["left", "right", "empty_row"])
def test_attention_dropout_matches_blk_grads_with_injected_mask(layout, S, kind):
    q, k, v, do, start, end, valid = _inputs(S, kind, seed=1)
    seed = torch.tensor([SEED + S], dtype=torch.int32)
    ks = whk.dropout_keep_scale(seed, B, H, S, RATE).numpy()
    want = _jax_blk_with_mask(q, k, v, do, start, end, ks)
    got = _port_fwd_bwd(layout, q, k, v, do, start, end, seed, RATE)
    _check(got, want, valid)
    # the mask really acts: without it the output differs
    plain = _port_fwd_bwd(layout, q, k, v, do, start, end, None, 0.0)
    vr = valid[:, None, :, None] & np.ones((1, H, 1, HD), bool)
    assert np.abs(plain[0][vr] - got[0][vr]).max() > 1e-2


def test_attention_qkv_is_the_train_path_and_launches_nothing_on_cpu():
    q, k, v, do, start, end, valid = _inputs(128, "left")
    mask = torch.from_numpy(np.arange(128)[None, :] >= start[:, None])
    qkv = torch.cat([torch.from_numpy(a).transpose(1, 2).reshape(B, 128, H * HD)
                     for a in (q, k, v)], dim=-1)
    seed = torch.tensor([5], dtype=torch.int32)
    counts = (whk.whole_head_attention.launches, whk.whole_head_attention_bwd.launches,
              whk.dropout_keep_scale.launches)
    out = attn.attention_qkv(qkv, mask, heads=H, seed=seed, rate=RATE)
    st, en = whk.mask_bounds_from_key_mask(mask)
    out2 = whk.whole_head_attention_bsd(*qkv.chunk(3, dim=-1), st, en, seed, heads=H,
                                        dropout_rate=RATE)
    torch.testing.assert_close(out, out2, rtol=0, atol=0)
    assert counts == (whk.whole_head_attention.launches,
                      whk.whole_head_attention_bwd.launches, whk.dropout_keep_scale.launches)


def test_packed_ok_takes_the_kernel_head_dims():
    assert attn.packed_ok(1024, 32, 24)
    assert attn.packed_ok(1024, 128, 12)
    assert not attn.packed_ok(2048, 32, 24)  # blocked kernels #6-#10
    assert not attn.packed_ok(1024, 16, 4)
    assert not attn.packed_ok(1024, 48, 4)


def test_port_xla_attention_takes_an_injected_mask():
    q, k, v, _, _, _, _ = _inputs(128, "left")
    mask = np.ones((B, 128), bool)
    seed = torch.tensor([3], dtype=torch.int32)
    ks = whk.dropout_keep_scale(seed, B, H, 128, RATE)
    got = attn.xla_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)), keep_scale=ks)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * HD ** -0.5
    logits = jnp.where(jnp.tril(jnp.ones((128, 128), bool)), logits, -1e9)
    # the JAX XLA path's dropout draws its own mask; its math with this one:
    want = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(logits, -1) * ks.numpy(), v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------- keep mask
def test_keep_mask_is_deterministic_in_seed_batch_head():
    seed = torch.tensor([1234], dtype=torch.int32)
    a = whk.dropout_keep_scale(seed, 3, 4, 96, RATE)
    b = whk.dropout_keep_scale(seed.clone(), 3, 4, 96, RATE)
    assert torch.equal(a, b)
    # (b, h) = (1, 2) of a [3, 4] grid is row 1 * 4 + 2 of the key stream:
    # the same element of any grid with the same head count
    c = whk.dropout_keep_scale(seed, 2, 4, 96, RATE)
    assert torch.equal(a[:2], c)


def test_keep_mask_is_identical_in_both_layouts():
    """The same seed gives the same dropout in [B,H,S,hd] and head-packed
    inputs: the mask depends on (seed, b, h, row, col) alone."""
    q, k, v, do, start, end, valid = _inputs(256, "left", seed=5)
    seed = torch.tensor([99], dtype=torch.int32)
    outs = {lay: _port_fwd_bwd(lay, q, k, v, do, start, end, seed, RATE)
            for lay in ("bhsd", "bsd", "qkv")}
    for lay in ("bsd", "qkv"):
        for g, w in zip(outs[lay], outs["bhsd"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_keep_mask_differs_across_heads_batches_and_seeds():
    s1 = torch.tensor([1], dtype=torch.int32)
    s2 = torch.tensor([2], dtype=torch.int32)
    a = whk.keep_bytes_reference(s1, 2, 3, 64)
    b = whk.keep_bytes_reference(s2, 2, 3, 64)
    flat = a.reshape(6, -1)
    for i in range(6):
        for j in range(i + 1, 6):
            # independent bytes agree 1/256 of the time
            assert (flat[i] == flat[j]).float().mean() < 0.02
    assert (a == b).float().mean() < 0.02


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_share_within_binomial_bounds_and_exact_scale(rate):
    seed = torch.tensor([777], dtype=torch.int32)
    ks = whk.dropout_keep_scale(seed, 2, 3, 256, rate)
    q = whk.keep_threshold(rate)
    assert q == round(rate * 256)
    p = 1.0 - q / 256.0
    n = ks.numel()
    share = (ks > 0).double().mean().item()
    assert abs(share - p) < 5.0 * np.sqrt(p * (1 - p) / n)
    scale = np.float32(1.0 / (1.0 - q / 256.0))
    assert set(np.unique(ks.numpy()).tolist()) == {0.0, float(scale)}
    # the realized-keep rescale preserves the mean exactly in expectation
    assert abs(ks.double().mean().item() - 1.0) < 5.0 * scale * np.sqrt(p * (1 - p) / n)


def test_keep_threshold_follows_the_tpu_kernel():
    assert whk.keep_threshold(0.1) == 26
    assert whk.keep_threshold(0.999) == 255  # capped, as _keep_scale caps it
    assert whk.keep_threshold(0.0) == 0


def test_philox_matches_the_published_known_answers():
    """Random123's philox4x32-10 known-answer vectors."""
    z = torch.zeros(1, dtype=torch.int64)
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    pi = [torch.tensor([x]) for x in (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344,
                                      0xA4093822, 0x299F31D0)]
    cases = [((z,) * 6, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((f,) * 6, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             (pi, (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for args, want in cases:
        got = whk._philox4x32_10(*args)
        assert tuple(int(w) for w in got) == want
