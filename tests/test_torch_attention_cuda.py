"""The whole-head attention CUDA kernel against its plain torch version.

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
    ends = [S, (S * 2) // 3, 1, S]
    starts = [0, 0, 0, S // 5]
    start = torch.tensor((starts * B)[:B], dtype=torch.int32, device=cuda)
    end = torch.tensor((ends * B)[:B], dtype=torch.int32, device=cuda)
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
