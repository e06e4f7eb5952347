"""The decode-attention (#14), fused loss-head (#15) and fused AdamW (#16)
CUDA kernels against their plain torch versions on the card.

Needs an NVIDIA Hopper card and nvcc; skipped elsewhere.  It imports no JAX,
so on the card it runs with the repository conftest (which imports jax) left
out:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from neko_tpu_torch.ops import decode_attention as da  # noqa: E402
from neko_tpu_torch.ops import fused_adamw as fa  # noqa: E402
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
