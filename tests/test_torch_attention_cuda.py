"""The attention CUDA kernels against their plain torch versions: the
whole-head forward and backward (autograd through the plain version) and the
blocked forward (o, m, l) and both blocked backward routes, the ring's
per-pair kernels and the ring as a whole, with dropout (the
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
    q = torch.randn(1, 1, 64, 256, device=cuda)  # hd 256: over the kernels' 128
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
    (2, 3, 200, 16, torch.bfloat16),   # hd 16: native bf16 backward, padded forward
    (2, 3, 200, 16, torch.float32),    # hd 16: padded to 32 both ways
    (2, 2, 160, 48, torch.bfloat16),   # an odd hd: padded to 64
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

    qkv = torch.randn(1, 2048, 3 * 2 * 256, device=cuda)  # hd 256: over the kernels' 128
    bounds = torch.tensor([0], dtype=torch.int32, device=cuda)
    before = ba.blocked_attention_fwd.launches
    with pytest.raises(ValueError):
        ba.blocked_attention_qkv(qkv, bounds, bounds + 2048, heads=2)
    assert ba.blocked_attention_fwd.launches == before


# ---------------------------------------------------- ring kernels #11-#13
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S_l,hd,dtype", [
    (2, 4, 512, 32, torch.bfloat16),
    (2, 3, 300, 64, torch.float32),    # ragged: offsets off the kernels' key tiles
    (3, 2, 200, 128, torch.float32),
    (2, 3, 300, 16, torch.bfloat16),   # the tensor-core tiles at hd 16 and 128, ragged
    (3, 2, 200, 128, torch.bfloat16),
])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("pair", [(1, 1), (2, 1), (2, 0), (0, 2)])
def test_ring_pair_kernels_match_plain(cuda, B, H, S_l, hd, dtype, rate, pair):
    """#11, #12 and #13 on one (q shard, kv shard) pair of a 3-shard sequence
    against their plain versions on the same values (which, in bf16, round
    p * keep and ds to bf16 before their products as the kernels do), with
    the pair's window of the plain Philox and the same L and delta; (0, 2) is
    a pair in the future of the q shard: every output is 0, m = -1e30."""
    from neko_tpu_torch.ops import ring_kernel as rk

    n = 3
    qkv, start, end, valid, dout = _blocked_inputs(B, H, n * S_l, hd, dtype, cuda)
    start = torch.minimum(start, torch.tensor(S_l + 70, device=cuda)).int()  # inside shard 1
    seed = torch.tensor([31], dtype=torch.int32, device=cuda)
    i, j = pair
    q, k, v = (t.chunk(n, dim=2)[s] for t, s in zip(whk._qkv_views("qkv", (qkv,), H), (i, j, j)))
    do = whk._heads4(dout, H).chunk(n, dim=2)[i]
    g = torch.Generator(device=cuda).manual_seed(1)
    delta = torch.randn(B, H, S_l, device=cuda, generator=g)
    at = (i * S_l, j * S_l, start, end)
    before = [f.launches for f in (rk.ring_partial_fwd, rk.ring_partial_dq, rk.ring_partial_dkv)]
    acc, m, l = rk.ring_partial_fwd(q, k, v, *at, seed, None, rate)
    # the log-sum-exp of a ring whose only pair this is (0 on rows without a key)
    L = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), 0.0)
    dq = rk.ring_partial_dq(q, k, v, do, L, delta, *at, seed, None, rate)
    dk, dv = rk.ring_partial_dkv(q, k, v, do, L, delta, *at, seed, None, rate)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(
        (rk.ring_partial_fwd, rk.ring_partial_dq, rk.ring_partial_dkv), before)] == [1, 1, 1]
    assert all(t.dtype == torch.float32 and torch.isfinite(t).all()
               for t in (acc, m, l, dq, dk, dv))
    ks = (whk.dropout_keep_scale_reference(seed, B, H, None, rate, rows=(at[0], at[0] + S_l),
                                           cols=(at[1], at[1] + S_l)) if rate else None)
    f32 = [t.float() for t in (q, k, v)]
    acc_w, m_w, l_w = rk.ring_partial_fwd_reference(*f32, *at, None, ks)
    dq_w = rk.ring_partial_dq_reference(q, k, v, do, L, delta, *at, None, ks)
    dk_w, dv_w = rk.ring_partial_dkv_reference(q, k, v, do, L, delta, *at, None, ks)
    rows = l_w > 0
    assert (m[~rows] == -1e30).all() and not l[~rows].any() and not acc[~rows].any()
    if not rk.pair_visible(at[0], at[1], S_l):
        assert not rows.any() and not dq.any() and not dk.any() and not dv.any()
    torch.testing.assert_close(m[rows], m_w[rows], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_w, atol=1e-5, rtol=1e-4)
    # acc is not divided by l: held relative to it (fp32 summation order)
    scale = l_w.clamp_min(1.0)[..., None]
    torch.testing.assert_close(acc / scale, acc_w / scale, atol=5e-6, rtol=0)
    for name, got, want in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)):
        if dtype == torch.bfloat16:
            _close_but_rare_flips(got, want, name)
        else:
            torch.testing.assert_close(got, want, atol=1e-4, rtol=2.0 ** -7,
                                       msg=lambda s, n=name: f"{n}: {s}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,S,hd,dtype", [(4, 2048, 32, torch.float32), (2, 1000, 64, torch.float32),
                                          (4, 1200, 32, torch.bfloat16)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ring_equals_blocked_kernels_at_one_seed(cuda, n, S, hd, dtype, rate):
    """The ring over n shards on the card against the blocked kernels at the
    same S and seed: the same mask, so the same attention and gradients (fp32
    to summation order; bf16 to the rounding of out and of the gradients),
    with n (n + 1) / 2 launches per ring kernel and none of the blocked."""
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import ring_kernel as rk

    B, H = 2, 4
    qkv, start, end, valid, dout = _blocked_inputs(B, H, S, hd, dtype, cuda)
    seed = torch.tensor([5], dtype=torch.int32, device=cuda)
    ring = (rk.ring_partial_fwd, rk.ring_partial_dq, rk.ring_partial_dkv)
    before = [f.launches for f in ring]
    x = qkv.clone().requires_grad_()
    o1 = rk.ring_attention_qkv(x, start, end, seed, n_shards=n, heads=H, dropout_rate=rate)
    (g1,) = torch.autograd.grad(o1, (x,), dout)
    assert [f.launches - b for f, b in zip(ring, before)] == [n * (n + 1) // 2] * 3
    x = qkv.clone().requires_grad_()
    o2 = ba.blocked_attention_qkv(x, start, end, seed, heads=H, dropout_rate=rate)
    (g2,) = torch.autograd.grad(o2, (x,), dout)
    assert torch.isfinite(o1).all() and torch.isfinite(g1).all() and not o1[~valid].any()
    o_tol = dict(atol=1e-5, rtol=0) if dtype == torch.float32 else dict(zip(("atol", "rtol"),
                                                                          TOL[dtype]))
    torch.testing.assert_close(o1[valid], o2[valid], **o_tol)
    torch.testing.assert_close(g1, g2, **dict(zip(("atol", "rtol"), GRAD_TOL[dtype])))


@pytest.mark.cuda
def test_ring_kernel_refuses_an_unsupported_head_dim(cuda):
    from neko_tpu_torch.ops import ring_kernel as rk

    qkv = torch.randn(1, 2048, 3 * 2 * 256, device=cuda)  # hd 256: over the kernels' 128
    bounds = torch.tensor([0], dtype=torch.int32, device=cuda)
    before = rk.ring_partial_fwd.launches
    with pytest.raises(ValueError):
        rk.ring_attention_qkv(qkv, bounds, bounds + 2048, n_shards=4, heads=2)
    assert rk.ring_partial_fwd.launches == before


# ----------------------------------- the bf16 backward tiles (tensor cores)
# Kernel against the plain backward on the same bf16 inputs and the kernel
# forward's own row stats and delta.  The plain side rounds p * keep and ds
# to bf16 before its products, as the kernels (and neko_tpu) do, and sums in
# fp32, so what remains is fp32 summation order (the fused dq's atomics
# included) and the rounding of the outputs to bf16: 1e-4 absolute plus one
# bf16 ulp relative (BWD_TOL).  But the two sides round p * keep and ds
# from fp32 values computed in other orders, and where one lands on the
# other side of a rounding boundary the operands differ by one bf16 ulp:
# the gradients that sum it move by one ulp of that term, which on rows that
# see few keys (p near 1) exceeds BWD_TOL.  So at most FLIP_SHARE of the
# values may exceed BWD_TOL, and none GRAD_TOL[bf16].  (The first H100 run
# read up to 16 of 153,600 values over BWD_TOL, up to 2.9e-2 over it on a
# pair with random, unnormalized L; a faulty tile moves most values.)
BWD_TOL = dict(atol=1e-4, rtol=2.0 ** -7)
FLIP_SHARE = 1e-3


def _close_but_rare_flips(got, want, name):
    """`got` within BWD_TOL of `want` on all but FLIP_SHARE of the values,
    and within GRAD_TOL[bf16] everywhere."""
    diff = (got.float() - want.float()).abs()
    w = want.float().abs()
    share = (diff > BWD_TOL["atol"] + BWD_TOL["rtol"] * w).double().mean().item()
    atol, rtol = GRAD_TOL[torch.bfloat16]
    worst = (diff - atol - rtol * w).max().item()
    assert share <= FLIP_SHARE and worst <= 0, (
        f"d{name}: {share:.2e} of the values over {BWD_TOL}, worst excess over "
        f"{GRAD_TOL[torch.bfloat16]} {worst:.3e}, max abs diff {diff.max().item():.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("entry", ["whole-head", "fused", "dq", "dkv"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_bf16_backward_tiles_match_plain(cuda, hd, entry, rate):
    """Every entry point of the tiles at each compiled head dim, on a ragged
    S with a left-padded row, a short row and a row that sees no key: the
    gradients of rows that see no key, and of keys no row sees, are exact
    zeros."""
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import ring_kernel as rk

    B, H, S = 4, 2, (1000 if entry == "whole-head" else 3000)
    qkv, start, end, valid, dout = _blocked_inputs(B, H, S, hd, torch.bfloat16, cuda, seed=hd)
    seed = torch.tensor([2024], dtype=torch.int32, device=cuda)
    q, k, v = whk._qkv_views("qkv", (qkv,), H)
    do = whk._heads4(dout, H)
    ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate else None
    if entry == "whole-head":
        out, lse = whk.whole_head_attention_fwd(q, k, v, start, end, seed, None, rate,
                                                need_lse=True)
        delta = ba.row_delta(do, out)
        before = whk.whole_head_attention_bwd.launches
        got = whk.whole_head_attention_bwd(q, k, v, out, do, lse, start, end, seed, None, rate)
        assert whk.whole_head_attention_bwd.launches == before + 1
        at = (lse, delta, 0, 0, start, end, None, ks)  # one ring "pair": the whole head
        want = (rk.ring_partial_dq_reference(q, k, v, do, *at),
                *rk.ring_partial_dkv_reference(q, k, v, do, *at))
    else:
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, rate)
        bwd = (q, k, v, do, m, l, ba.row_delta(do, out), start, end)
        plain = ba.blocked_bwd_fused_reference(*bwd, None, ks)
        if entry == "fused":
            got, want = ba.blocked_attention_bwd_fused(*bwd, seed, None, rate), plain
        elif entry == "dq":
            got, want = (ba.blocked_attention_dq(*bwd, seed, None, rate),), plain[:1]
        else:
            got, want = ba.blocked_attention_dkv(*bwd, seed, None, rate), plain[1:]
    torch.cuda.synchronize()
    names = {"whole-head": "qkv", "fused": "qkv", "dq": "q", "dkv": "kv"}[entry]
    rows = valid[:, None, :, None]
    # keys no row sees: before start (every row sees its key c from row c on)
    seen_keys = (torch.arange(S, device=cuda)[None, :] >= start[:, None].long()) & \
        (start < end)[:, None]
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all(), name
        _close_but_rare_flips(g, w, name)
        unseen = ~rows if name == "q" else ~seen_keys[:, None, :, None]
        assert not g.masked_fill(~unseen, 0).any(), f"d{name} not 0 where nothing is seen"


@pytest.mark.cuda
def test_bf16_backward_refuses_misaligned_rows(cuda):
    """The tiles copy 16 bytes at a time: a view whose rows are not 16-byte
    aligned is refused, never run through another path."""
    B, H, S, hd = 1, 2, 64, 32
    x = torch.randn(B, H, S, hd + 1, device=cuda).bfloat16()[..., 1:]  # rows off by 2 bytes
    start = torch.zeros(B, dtype=torch.int32, device=cuda)
    end = torch.full((B,), S, dtype=torch.int32, device=cuda)
    lse = torch.zeros(B, H, S, device=cuda)
    before = whk.whole_head_attention_bwd.launches
    with pytest.raises(ValueError):
        whk.whole_head_attention_bwd(x, x, x, x, x, lse, start, end)
    assert whk.whole_head_attention_bwd.launches == before
