"""The attention CUDA kernels against their plain torch versions: the
whole-head forward and backward (autograd through the plain version) and the
blocked forward (o, m, l) and both blocked backward routes, with dropout (the
same mask: the plain version gets the keep/scale matrix the mask kernel
writes, and that matrix must equal the plain Philox bit for bit), on
contiguous [B, H, S, hd] tensors and on head-packed strided views of one
[B, S, 3*H*hd] tensor.

Needs an NVIDIA Hopper card and nvcc; skipped elsewhere.  It imports no JAX,
so on the card it runs with the repository conftest (which imports jax) left
out:

    python -m pytest --noconftest tests/test_torch_attention_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# tolerances (atol, rtol): bf16 outputs are rounded to 8 significant bits,
# and the kernel keeps p in fp32 where the plain version rounds it to bf16
# before the value product (as the TPU kernel does): 1e-2 absolute plus one
# bf16 ulp relative (outputs reach |x| ~ 4 on rows with few keys, where one
# ulp is 1.56e-2).  fp32: summation order only.
TOL = {torch.bfloat16: (1e-2, 2.0 ** -7), torch.float32: (1e-5, 0.0)}
# gradients: sums over up to S terms of products of rounded factors.  bf16:
# 3e-2 absolute plus two bf16 ulps relative (the gradient is rounded to bf16
# once, the plain version's p once more before dv; gradients reach |x| ~ 8);
# fp32: summation order over S keys.
GRAD_TOL = {torch.bfloat16: (3e-2, 2.0 ** -6), torch.float32: (5e-5, 1e-4)}


def _bounds(B, S, cuda):
    ends = [S, (S * 2) // 3, 1, S]
    starts = [0, 0, 0, S // 5]
    return (torch.tensor((starts * B)[:B], dtype=torch.int32, device=cuda),
            torch.tensor((ends * B)[:B], dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (8, 24, 1024, 32, torch.bfloat16),   # flagship prefill
    (2, 4, 200, 32, torch.float32),      # ragged S (not a tile multiple)
    (2, 4, 384, 64, torch.float32),
    (2, 4, 256, 128, torch.float32),
    (2, 4, 256, 128, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, B, H, S, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(B, H, S, hd, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    start, end = _bounds(B, S, cuda)
    before = whk.whole_head_attention.launches
    out = whk.whole_head_attention(q, k, v, start, end)
    torch.cuda.synchronize()
    assert whk.whole_head_attention.launches == before + 1
    ref = whk.whole_head_attention_reference(q, k, v, start, end)
    assert torch.isfinite(out).all()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_kernel_refuses_cpu_fallback_inputs(cuda):
    q = torch.randn(1, 1, 64, 48, device=cuda)  # hd 48: no kernel template
    bounds = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        whk.whole_head_attention(q, q, q, bounds, bounds + 64)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S", [(2, 3, 200), (1, 2, 1024), (3, 1, 17)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_mask_kernel_equals_plain_philox_bit_for_bit(cuda, B, H, S, rate):
    seed = torch.tensor([987654321], dtype=torch.int32, device=cuda)
    before = whk.dropout_keep_scale.launches
    got = whk.dropout_keep_scale(seed, B, H, S, rate)
    assert whk.dropout_keep_scale.launches == before + 1
    want = whk.dropout_keep_scale_reference(seed, B, H, S, rate)
    assert torch.equal(got, want)
    scale = torch.tensor(whk.survivor_scale(whk.keep_threshold(rate)), dtype=torch.float32)
    assert set(got.unique().tolist()) <= {0.0, scale.item()}


def _grads_check(out, ref, grads, ref_grads, valid_rows, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float()[valid_rows], ref.float()[valid_rows],
                               atol=atol, rtol=rtol)
    atol, rtol = GRAD_TOL[dtype]
    for name, g, r in zip("qkv", grads, ref_grads):
        assert torch.isfinite(g).all(), name
        torch.testing.assert_close(g.float(), r.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, n=name: f"d{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (2, 4, 256, 32, torch.bfloat16),
    (2, 3, 200, 32, torch.float32),
    (2, 2, 192, 64, torch.float32),
    (2, 2, 128, 128, torch.float32),
    (2, 2, 128, 128, torch.bfloat16),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_matches_autograd_through_plain(cuda, B, H, S, hd, dtype, rate):
    """[B, H, S, hd] layout; do is zero on rows that see no key."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(B, H, S, hd, device=cuda, generator=g).to(dtype)
               .requires_grad_() for _ in range(3))
    start, end = _bounds(B, S, cuda)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    rows = torch.arange(S, device=cuda)[None, :]
    valid = ((rows >= start[:, None].long()) & (start < end)[:, None])[:, None, :, None]
    dout = torch.randn(B, H, S, hd, device=cuda, generator=g).to(dtype) * valid
    before = whk.whole_head_attention_bwd.launches
    out = whk.whole_head_attention(q, k, v, start, end, seed, dropout_rate=rate)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert whk.whole_head_attention_bwd.launches == before + 1
    ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate else None
    ref = whk.whole_head_attention_reference(q, k, v, start, end, None, ks)
    ref_grads = torch.autograd.grad(ref, (q, k, v), dout)
    _grads_check(out, ref, grads, ref_grads, valid.expand_as(out), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_head_packed_strided_views_forward_and_backward(cuda, dtype, rate):
    """q, k, v as the column slices of one [B, S, 3*H*hd] tensor (sequence
    stride 3*H*hd): the same results as the [B, H, S, hd] layout, the same
    mask, and one [B, S, 3*H*hd] gradient."""
    B, H, S, hd = 3, 4, 160, 32
    D = H * hd
    g = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(B, S, 3 * D, device=cuda, generator=g).to(dtype).requires_grad_()
    start = torch.tensor([0, 40, S], dtype=torch.int32, device=cuda)  # left-padded, empty row
    end = torch.tensor([S, S, 0], dtype=torch.int32, device=cuda)
    seed = torch.tensor([77], dtype=torch.int32, device=cuda)
    rows = torch.arange(S, device=cuda)[None, :]
    valid = ((rows >= start[:, None].long()) & (start < end)[:, None])[..., None]
    dout = torch.randn(B, S, D, device=cuda, generator=g).to(dtype) * valid
    out = whk.whole_head_attention_qkv(qkv, start, end, seed, heads=H, dropout_rate=rate)
    (dqkv,) = torch.autograd.grad(out, (qkv,), dout)
    assert dqkv.shape == qkv.shape and dqkv.is_contiguous()

    def bhsd(t):
        return t.detach().unflatten(-1, (H, hd)).transpose(1, 2).contiguous().requires_grad_()

    q, k, v = (bhsd(t) for t in qkv.chunk(3, dim=-1))
    out4 = whk.whole_head_attention(q, k, v, start, end, seed, dropout_rate=rate)
    do4 = dout.unflatten(-1, (H, hd)).transpose(1, 2)
    grads4 = torch.autograd.grad(out4, (q, k, v), do4)
    # same kernels, same mask, other strides: equal to rounding of the sums
    torch.testing.assert_close(out, out4.transpose(1, 2).reshape(B, S, D), atol=0, rtol=0)
    for got, want in zip(dqkv.chunk(3, dim=-1), grads4):
        torch.testing.assert_close(got, want.transpose(1, 2).reshape(B, S, D), atol=0, rtol=0)
    ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate else None
    ref = whk.whole_head_attention_reference(q, k, v, start, end, None, ks)
    ref_grads = torch.autograd.grad(ref, (q, k, v), do4)
    _grads_check(out4, ref, grads4, ref_grads, valid[:, None].expand_as(out4), dtype)


# ------------------------------------------------- blocked kernels #6-#9
def _blocked_inputs(B, H, S, hd, dtype, cuda, seed=3):
    """qkv [B, S, 3*H*hd] (q, k, v its column slices), left-padded, short
    and empty rows, do zero where no key is seen."""
    D = H * hd
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(B, S, 3 * D, device=cuda, generator=g).to(dtype)
    starts = [0, S // 7, S - 37, S]
    ends = [S, S, S, 0]
    start = torch.tensor((starts * B)[:B], dtype=torch.int32, device=cuda)
    end = torch.tensor((ends * B)[:B], dtype=torch.int32, device=cuda)
    rows = torch.arange(S, device=cuda)[None, :]
    valid = (rows >= start[:, None].long()) & (start < end)[:, None]
    dout = torch.randn(B, S, D, device=cuda, generator=g).to(dtype) * valid[..., None]
    return qkv, start, end, valid, dout


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (2, 4, 1100, 32, torch.bfloat16),   # ragged S: no multiple of the 64 x 32 tiles
    (4, 3, 700, 64, torch.float32),
    (2, 2, 600, 128, torch.float32),
    (3, 2, 1300, 128, torch.bfloat16),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("route", ["fused", "three-pass"])
def test_blocked_kernels_match_plain(cuda, B, H, S, hd, dtype, rate, route, monkeypatch):
    """#6 (o, m, l) and, through `blocked_attention_qkv`, #8 or #7 + #9
    against the plain versions with the same keep mask, given the plain
    forward's (m, l) and delta."""
    from neko_tpu_torch.ops import blocked_attention as ba

    monkeypatch.setattr(ba, "FUSED_MAX", S if route == "fused" else S - 1)
    qkv, start, end, valid, dout = _blocked_inputs(B, H, S, hd, dtype, cuda)
    seed = torch.tensor([99], dtype=torch.int32, device=cuda)
    q, k, v = whk._qkv_views("qkv", (qkv,), H)
    launches = [f.launches for f in (ba.blocked_attention_fwd, ba.blocked_attention_bwd_fused,
                                     ba.blocked_attention_dq, ba.blocked_attention_dkv)]
    out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, dropout_rate=rate)
    x = qkv.clone().requires_grad_()
    out2 = ba.blocked_attention_qkv(x, start, end, seed, heads=H, dropout_rate=rate)
    (dqkv,) = torch.autograd.grad(out2, (x,), dout)
    torch.cuda.synchronize()
    fused = route == "fused"
    assert [f.launches - n for f, n in zip(
        (ba.blocked_attention_fwd, ba.blocked_attention_bwd_fused, ba.blocked_attention_dq,
         ba.blocked_attention_dkv), launches)] == [2, int(fused), int(not fused), int(not fused)]
    ks = ba.dropout_keep_scale(seed, B, H, S, rate) if rate else None
    ref, m_ref, l_ref = ba.blocked_fwd_reference(q, k, v, start, end, None, ks)
    ok = valid[:, None, :, None].expand_as(out)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(out.float()[ok], ref.float()[ok], atol=atol, rtol=rtol)
    torch.testing.assert_close(out2, out.transpose(1, 2).reshape(B, S, -1), atol=0, rtol=0)
    rows = valid[:, None, :].expand_as(m)
    torch.testing.assert_close(m[rows], m_ref[rows], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l[rows], l_ref[rows], atol=1e-5, rtol=1e-4)
    assert (m[~rows] == -1e30).all() and not l[~rows].any() and not out[~ok].any()
    do4 = whk._heads4(dout, H)
    want = ba.blocked_bwd_fused_reference(q, k, v, do4, m_ref, l_ref, ba.row_delta(do4, ref),
                                          start, end, None, ks)
    atol, rtol = GRAD_TOL[dtype]
    for name, got, w in zip("qkv", dqkv.chunk(3, dim=-1), want):
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got.float(), w.transpose(1, 2).reshape(B, S, -1).float(),
                                   atol=atol, rtol=rtol, msg=lambda s, n=name: f"d{n}: {s}")


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_blocked_kernels_equal_whole_head_kernels_at_s_1024(cuda, rate):
    """One seed gives one mask: at S = 1024 the blocked and the whole-head
    kernels compute the same attention and gradients (to summation order)."""
    from neko_tpu_torch.ops import blocked_attention as ba

    B, H, S, hd = 2, 4, 1024, 32
    qkv, start, end, valid, dout = _blocked_inputs(B, H, S, hd, torch.float32, cuda)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    res = []
    for fn in (ba.blocked_attention_qkv, whk.whole_head_attention_qkv):
        x = qkv.clone().requires_grad_()
        out = fn(x, start, end, seed, heads=H, dropout_rate=rate)
        res.append((out, *torch.autograd.grad(out, (x,), dout)))
    (o1, g1), (o2, g2) = res
    torch.testing.assert_close(o1[valid], o2[valid], atol=1e-5, rtol=0)
    torch.testing.assert_close(g1, g2, atol=5e-5, rtol=1e-4)


@pytest.mark.cuda
def test_blocked_kernel_refuses_an_unsupported_head_dim(cuda):
    from neko_tpu_torch.ops import blocked_attention as ba

    qkv = torch.randn(1, 2048, 3 * 2 * 48, device=cuda)  # hd 48: no kernel template
    bounds = torch.tensor([0], dtype=torch.int32, device=cuda)
    before = ba.blocked_attention_fwd.launches
    with pytest.raises(ValueError):
        ba.blocked_attention_qkv(qkv, bounds, bounds + 2048, heads=2)
    assert ba.blocked_attention_fwd.launches == before
