"""The decode-attention (#14, over a native and an int8 cache, split over a
thread-block cluster), fused
loss-head (#15), fused AdamW (#16), dropout-mask (#5/#10) and erf GELU
CUDA kernels against their plain torch versions on the card.

Needs an NVIDIA Hopper card and nvcc; skipped elsewhere.  It imports no JAX,
so on the card it runs with the repository conftest (which imports jax) left
out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import decode_attention as da  # noqa: E402
from neko_tpu_torch.ops import fused_adamw as fa  # noqa: E402
from neko_tpu_torch.ops import gelu  # noqa: E402
from neko_tpu_torch.ops import loss_kernel as lk  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# decode: bf16 outputs are rounded to 8 significant bits and the plain
# version rounds p to bf16 before the value product: 1e-2 absolute plus one
# bf16 ulp relative; fp32: summation order only
DECODE_TOL = {torch.bfloat16: (1e-2, 2.0 ** -7), torch.float32: (1e-5, 1e-5)}


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (8, 24, 1024, 32, torch.bfloat16),   # the flagship decode step
    (1, 24, 1024, 32, torch.bfloat16),
    (3, 8, 1000, 64, torch.float32),     # ragged S
    (3, 8, 512, 128, torch.float32),
    (3, 8, 512, 128, torch.bfloat16),
    (4, 4, 300, 16, torch.bfloat16),     # hd 16, compiled natively
    (4, 4, 300, 16, torch.float32),
    (2, 4, 300, 48, torch.bfloat16),     # an odd hd: padded to 64
])
def test_decode_kernel_matches_plain(cuda, B, H, S, hd, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, H, S, hd, device=cuda, generator=g).to(dtype) for _ in range(2))
    # a full cache, a left-padded start, one key, no key
    start = torch.tensor(([0, S // 3, 17, S] * B)[:B], dtype=torch.int32, device=cuda)
    end = torch.tensor(([S, S, 18, 0] * B)[:B], dtype=torch.int32, device=cuda)
    before = da.decode_cache_attention.launches
    out = da.decode_cache_attention(q, k, v, start, end)
    torch.cuda.synchronize()
    assert da.decode_cache_attention.launches == before + 1
    ref = da.decode_cache_attention_reference(q, k, v, start, end)
    assert torch.isfinite(out).all()
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,dtype", [(32, torch.bfloat16), (16, torch.bfloat16),
                                      (64, torch.float32)])
def test_decode_kernel_skips_holes_in_the_cache_mask(cuda, hd, dtype):
    """Rows inside the window whose mask bit is clear are not attended: the
    kernel against the plain version over the same mask, and against the
    plain version over the window alone (which must differ)."""
    B, H, S = 4, 8, 512
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(B, H, hd, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, H, S, hd, device=cuda, generator=g).to(dtype) for _ in range(2))
    mask = torch.rand(B, S, device=cuda, generator=g) < 0.7  # holes everywhere
    mask[3] = False
    mask[3, 100] = mask[3, 200] = True   # two keys 100 rows apart
    mask[2, 40:] = False                 # a window whose tail is all holes
    start, end = (t.to(cuda) for t in whk.mask_bounds_from_key_mask(mask))
    out = da.decode_cache_attention(q, k, v, start, end, mask)
    ref = da.decode_cache_attention_reference(q, k, v, start, end, key_mask=mask)
    window_only = da.decode_cache_attention_reference(q, k, v, start, end)
    torch.cuda.synchronize()
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    assert ((out.float() - window_only.float()).abs().amax(dim=(1, 2)) > 2 * atol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype", [
    (8, 24, 1024, 32, torch.bfloat16),   # the flagship decode step, int8 cache
    (1, 24, 1024, 32, torch.bfloat16),
    (3, 8, 1000, 64, torch.float32),     # ragged S
    (3, 8, 512, 128, torch.bfloat16),
    (4, 4, 300, 16, torch.bfloat16),     # one 16-byte load a row
    (2, 4, 300, 48, torch.bfloat16),     # an odd hd: zero columns to 64
])
def test_decode_int8_kernel_matches_plain(cuda, B, H, S, hd, dtype):
    """#14 over an int8 cache (int8 rows, fp32 row scales) against its plain
    version, with holes in the mask and the rows of
    test_decode_kernel_matches_plain; the bf16 kernel is not launched."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, H, hd, device=cuda, generator=g).to(dtype)
    kq, ks = da.quant_rows(torch.randn(B, H, S, hd, device=cuda, generator=g) * 2)
    vq, vs = da.quant_rows(torch.randn(B, H, S, hd, device=cuda, generator=g))
    start = torch.tensor(([0, S // 3, 17, S] * B)[:B], dtype=torch.int32, device=cuda)
    end = torch.tensor(([S, S, 18, 0] * B)[:B], dtype=torch.int32, device=cuda)
    mask = torch.rand(B, S, device=cuda, generator=g) < 0.7
    mask[:, 17] = True
    before = (da.decode_cache_attention_int8.launches, da.decode_cache_attention.launches)
    out = da.decode_cache_attention_int8(q, kq, ks, vq, vs, start, end, mask)
    torch.cuda.synchronize()
    assert (da.decode_cache_attention_int8.launches, da.decode_cache_attention.launches) == (
        before[0] + 1, before[1])
    ref = da.decode_cache_attention_int8_reference(q, kq, ks, vq, vs, start, end, key_mask=mask)
    assert torch.isfinite(out).all()
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    unscaled = da.decode_cache_attention_int8_reference(q, kq, torch.ones_like(ks), vq, vs,
                                                        start, end, key_mask=mask)
    assert (out.float() - unscaled.float()).abs().max() > 2 * atol  # the key scales count


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,hd,dtype,int8", [
    (8, 1, 1024, 32, torch.bfloat16, False),   # 8 windows: a cluster of 8 blocks on an H100
    (8, 6, 1024, 128, torch.float32, False),   # 48 windows: 4
    (8, 12, 2048, 16, torch.bfloat16, False),  # 96: 2
    (8, 24, 8192, 32, torch.bfloat16, False),  # 192: one block, a long cache
    (1, 24, 8192, 32, torch.bfloat16, False),  # 8 over a long cache
    (8, 1, 1024, 32, torch.bfloat16, True),
    (8, 6, 1002, 64, torch.float32, True),     # S no multiple of 4: the scale rows padded
    (1, 24, 8192, 32, torch.bfloat16, True),
])
def test_decode_split_edges_match_plain(cuda, B, H, S, hd, dtype, int8):
    """Windows on and across the edges of the split: shorter than the
    cluster, exactly as long, one key, no key (empty, start > end), a start
    no multiple of 4 (with the second share cleared from the mask), 3n + 1
    rows, n + 1 rows across a 4-row boundary; against the plain version and
    the plain split; one launch a call on the instance's own counter."""
    g = torch.Generator(device=cuda).manual_seed(S + hd + B)
    q = torch.randn(B, H, hd, device=cuda, generator=g).to(dtype)
    n = da.kernel_split(q, S)
    st = [37, 100, 515, 700, 5, 2, 900, 126]
    en = [37 + max(n - 1, 1), 100 + n, 516, 700, S - 3, 2 + 3 * n + 1, 300, 126 + n + 1]
    start = torch.tensor(st[:B] if B > 1 else [5], dtype=torch.int32, device=cuda)
    end = torch.tensor(en[:B] if B > 1 else [S - 3], dtype=torch.int32, device=cuda)
    mask = torch.rand(B, S, device=cuda, generator=g) < 0.7
    mask[torch.arange(B, device=cuda), start.long().clamp(max=S - 1)] = True
    lo, hi = da.split_bounds(start.clamp(min=0), end.clamp(max=S), n)
    row = min(4, B - 1)
    if n > 1:
        mask[row, int(lo[row, 1]):int(hi[row, 1])] = False  # a whole share cleared
    counters = (da.decode_cache_attention, da.decode_cache_attention_int8)
    before = [c.launches for c in counters]
    if int8:
        kq, ks = da.quant_rows(torch.randn(B, H, S, hd, device=cuda, generator=g) * 2)
        vq, vs = da.quant_rows(torch.randn(B, H, S, hd, device=cuda, generator=g))
        args = (q, kq, ks, vq, vs, start, end)
        out = da.decode_cache_attention_int8(*args, mask)
        ref = da.decode_cache_attention_int8_reference(*args, key_mask=mask)
        split = da.decode_cache_attention_split_reference(q, kq, vq, start, end, n, key_mask=mask,
                                                          scales=(ks, vs))
    else:
        k, v = (torch.randn(B, H, S, hd, device=cuda, generator=g).to(dtype) for _ in range(2))
        out = da.decode_cache_attention(q, k, v, start, end, mask)
        ref = da.decode_cache_attention_reference(q, k, v, start, end, key_mask=mask)
        split = da.decode_cache_attention_split_reference(q, k, v, start, end, n, key_mask=mask)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == ([0, 1] if int8 else [1, 0])
    assert torch.isfinite(out).all()
    assert torch.all(out[start >= end] == 0)
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(out.float(), split.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,V,valid", [(4096, 768, 52480, 52000), (300, 64, 1000, 1000),
                                         (3328, 768, 52480, 51000)])
def test_loss_kernel_matches_plain(cuda, N, D, V, valid):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(N, D, device=cuda, generator=g).bfloat16()
    W = (torch.randn(V, D, device=cuda, generator=g) * 0.02).bfloat16()
    t = torch.randint(0, valid, (N,), device=cuda, generator=g)
    logz, tl = lk.fused_logz_tl(x, t, W, valid)
    torch.cuda.synchronize()
    want_logz, want_tl = lk.fused_logz_tl_reference(x, t, W, valid)
    # fp32 sums of the same exact bf16 products, in another order
    torch.testing.assert_close(logz, want_logz, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(tl, want_tl, atol=1e-4, rtol=1e-5)


# fused loss head: fp32 sums of the same exact bf16 products, in another
# order, and exp through ex2.approx (2 ulp): logz ~ 11, target logits ~ 0.5
LOSS_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 96, 768])          # 96: a ragged last 64-deep slice
@pytest.mark.parametrize("V,valid", [(52480, 52305), (1000, 1000)])
@pytest.mark.parametrize("N", [1, 3328, 4097])         # 4097: one row past a row block
def test_loss_kernel_ragged_edges_match_plain(cuda, N, D, V, valid):
    """Every edge TMA zero-fills (rows past N, columns past V, depth past D)
    and the targets at column 0, at a tile's last column and at the last
    valid column."""
    g = torch.Generator(device=cuda).manual_seed(N + D + V)
    x = torch.randn(N, D, device=cuda, generator=g).bfloat16()
    W = (torch.randn(V, D, device=cuda, generator=g) * 0.02).bfloat16()
    t = torch.randint(0, valid, (N,), device=cuda, generator=g)
    t[0::3] = 0
    t[1::3] = 127
    t[2::3] = valid - 1
    before = lk.fused_logz_tl.launches
    logz, tl = lk.fused_logz_tl(x, t, W, valid)
    torch.cuda.synchronize()
    assert lk.fused_logz_tl.launches == before + 1
    want_logz, want_tl = lk.fused_logz_tl_reference(x, t, W, valid)
    assert torch.isfinite(logz).all() and torch.isfinite(tl).all()
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    torch.testing.assert_close(tl, want_tl, **LOSS_TOL)


@pytest.mark.cuda
def test_loss_kernel_refuses_unsupported_shapes(cuda):
    x = torch.randn(16, 100, device=cuda).bfloat16()  # D % 8 != 0
    t = torch.zeros(16, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError):
        lk.fused_logz_tl(x, t, torch.randn(300, 100, device=cuda).bfloat16())
    with pytest.raises(ValueError):
        lk.fused_logz_tl(x[:, :96].float(), t, torch.randn(300, 96, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S", [
    (2, 3, 1), (2, 3, 17), (3, 4, 128), (2, 3, 1024), (1, 2, 2048),
    (2, 2, 1000),                                    # S no multiple of 16
])
def test_mask_kernel_bit_for_bit_at_every_width(cuda, B, H, S):
    seed = torch.tensor([20240601], dtype=torch.int32, device=cuda)
    before = whk.dropout_keep_scale.launches
    got = whk.dropout_keep_scale(seed, B, H, S, 0.1)
    torch.cuda.synchronize()
    assert whk.dropout_keep_scale.launches == before + 1
    want = whk.dropout_keep_scale_reference(seed, B, H, S, 0.1)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_adamw_kernel_equals_plain_bit_for_bit(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    shapes = [(2304, 768), (768,), (5,), (4097,), (1000, 3)]
    params = [torch.randn(s, device=cuda, generator=g) * 0.02 for s in shapes]
    grads = [torch.randn(s, device=cuda, generator=g) for s in shapes]
    grads[2] = None  # a zero gradient
    runs = []
    for apply in (fa.fused_adamw_apply, fa.fused_adamw_apply_reference):
        ps = [p.clone() for p in params]
        st = fa.init_fused_adamw_state(ps)
        for step in range(3):
            bc1, bc2 = fa.bias_corrections(step, 0.9, 0.95)
            scale = fa.clip_scale_from_norm(fa.global_norm(grads), 1.0)
            apply(ps, grads, st.mu, st.nu, scale, lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                  bc1=bc1, bc2=bc2)
        runs.append(ps + st.mu + st.nu)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def ulps_apart(a, b):
    """|a - b| in units in the last place of their dtype, element by element
    (the bit patterns in sign-magnitude order)."""
    ints, mask = {torch.float32: (torch.int32, 0x7FFFFFFF),
                  torch.bfloat16: (torch.int16, 0x7FFF)}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & mask), i)

    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("make,dtype", [
    (lambda d: torch.randn(4096, 6144, device=d), torch.bfloat16),    # an MLP activation's rows
    (lambda d: torch.randn(128, 1, 6144, device=d), torch.bfloat16),   # a decode step
    (lambda d: torch.randn(64, 16, 16, 128, device=d).permute(0, 3, 1, 2),  # NHWC as NCHW
     torch.bfloat16),
    (lambda d: torch.randn(1_000_003, device=d), torch.float32),       # ragged
    (lambda d: torch.randn(1_000_003, device=d)[1:], torch.bfloat16),  # not 16-byte aligned
    (lambda d: torch.randn(3, 1001, device=d)[:, ::2], torch.float32),  # strided
])
def test_gelu_kernel_matches_plain(cuda, make, dtype):
    torch.manual_seed(0)
    x = (make(cuda) * 4).to(dtype)
    g = torch.randn(x.shape, device=cuda).to(dtype)
    xg = x.clone().requires_grad_()
    before = gelu.gelu_erf.launches
    y = gelu.gelu_erf(xg)
    y.backward(g)
    with torch.no_grad():
        y_served = gelu.gelu_erf(x)
    torch.cuda.synchronize()
    assert gelu.gelu_erf.launches == before + 3
    want, dwant = gelu.gelu_erf_reference(x), gelu.gelu_erf_grad_reference(x, g)
    assert y.dtype == xg.grad.dtype == dtype and y.shape == x.shape
    tol = 2 if dtype == torch.float32 else 1
    for got, ref in ((y.detach(), want), (y_served, want), (xg.grad, dwant)):
        assert int(ulps_apart(got, ref).max()) <= tol
