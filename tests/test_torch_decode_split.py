"""The split of kernel #14 (decode-step cache attention) in plain torch,
against neko_tpu on the CPU.

The kernel splits each (b, h) window over a cluster of n blocks: each takes
the share `split_bounds` gives it, keeps a partial (m, l, acc) in fp32, and
rank 0 merges them with the max rescale.
`decode_cache_attention_split_reference` is that split in plain torch.

* `split_bounds` covers every window once, in order, for n in {1, 2, 3, 8}:
  empty windows (start == end, start > end), one key, windows shorter than
  n, exactly n, and long ones whose start is no multiple of 4.
* `split_count` comes from the shapes and the SM count alone.
* The split version at n in {1, 2, 3, 8} against neko_tpu's
  `decode_cache_attention` Pallas kernel in interpret mode, at shapes and
  tolerances of test_torch_decode_attention.py's
  `test_plain_matches_jax_kernel` (fp32 2e-5 absolute; bf16 1e-2 absolute
  plus one bf16 ulp relative).
* The split over an int8 cache (its row scales passed) against neko_tpu's `_quant_cache_attention` over the
  same windows and a holed mask: fp32 queries, atol 1e-5, as
  test_torch_kv_quant.py holds the unsplit version.
* The wrapper's layout check refuses a cache whose (b, h) rows are not one
  contiguous run and scale rows that do not start on 16 bytes;
  `_aligned_rows` gives scales with an S that is no multiple of 4 such rows.

The CUDA kernel against these versions is in test_torch_kernels_cuda.py
(card only)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from neko_tpu.models.transformer import _quant_cache_attention, _quant_rows  # noqa: E402
from neko_tpu.ops import decode_attention as jax_da  # noqa: E402

from neko_tpu_torch.ops import decode_attention as da  # noqa: E402

TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=1e-2, rtol=2.0 ** -7)}
SPLITS = (1, 2, 3, 8)


@pytest.mark.parametrize("n", SPLITS)
def test_split_bounds_cover_each_window_once(n):
    S = 1024
    start = torch.tensor([0, 5, 9, 700, 37, 100, 515, 13, 3, 900, 0], dtype=torch.int32)
    end = torch.tensor([S, S - 3, 9, 300, 37 + n - 1, 100 + n, 516, 13 + 3 * n + 1, 4, 901, 1],
                       dtype=torch.int32)
    lo, hi = da.split_bounds(start, end, n)
    assert lo.shape == hi.shape == (len(start), n)
    for b in range(len(start)):
        covered = [j for r in range(n) for j in range(int(lo[b, r]), int(hi[b, r]))]
        # every row of the window once, in order; nothing outside it
        assert covered == list(range(int(start[b]), max(int(end[b]), int(start[b]))))
        sizes = (hi[b] - lo[b]).tolist()
        assert all(s >= 0 for s in sizes) and lo[b, 0] == start[b]
        assert all(hi[b, r] == lo[b, r + 1] for r in range(n - 1))
        if sizes[0]:  # ceil(len / n) rows a share, the last ones short or empty
            assert max(sizes) == sizes[0] == -(-sum(sizes) // n)


def test_split_count_from_shapes_and_sms():
    assert da.split_count(1, 24, 1024, 132) == 8   # one request: 24 windows
    assert da.split_count(8, 24, 1024, 132) == 1   # the flagship's 192 fill the SMs
    assert da.split_count(8, 12, 1024, 132) == 2   # GPT-2 small's heads
    assert da.split_count(1, 24, 8192, 132) == 8
    assert da.split_count(1, 24, 300, 132) == 2    # at least 128 rows a block
    assert da.split_count(1, 1, 64, 132) == 1
    assert all(1 <= da.split_count(B, 24, 4096, 132) <= da.MAX_SPLIT for B in range(1, 20))


@functools.lru_cache(maxsize=None)
def _jax_case(dtype, H, S, hd):
    """(q, k, v, start, end, the JAX kernel's output): rows with a full
    cache, a left-padded start, one key, a short window, n = 8 rows, fewer
    rows than n."""
    rng = np.random.default_rng(hd + S + H)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((6, H, hd), (6, H, S, hd), (6, H, S, hd)))
    start = np.array([0, S // 3, 57, 0, 5, 3], np.int32)
    index = np.array([S - 1, S - 1, 57, 9, 12, 5], np.int32)  # newest row, inclusive
    jd = getattr(jnp, dtype)
    want, _, _ = jax_da.decode_cache_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), jnp.asarray(index), jnp.asarray(start))
    return q, k, v, start, index + 1, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("n", SPLITS)
@pytest.mark.parametrize("dtype,H,S,hd", [("float32", 8, 128, 32), ("bfloat16", 8, 128, 32),
                                          ("float32", 8, 128, 128)])
def test_split_matches_jax_kernel(dtype, H, S, hd, n):
    q, k, v, start, end, want = _jax_case(dtype, H, S, hd)
    td = getattr(torch, dtype)
    got = da.decode_cache_attention_split_reference(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), torch.from_numpy(start),
        torch.from_numpy(end), n)
    assert got.dtype == td and got.shape == (6, H, hd)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("n", SPLITS)
def test_int8_split_matches_jax(n):
    """Windows across the shares' edges, holes in the mask (one clearing the
    second share of a row), a row with no key (0, never NaN)."""
    rng = np.random.default_rng(7 + n)
    B, H, S, hd = 6, 3, 64, 32
    q = rng.standard_normal((B, H, 1, hd)).astype(np.float32)
    k = rng.standard_normal((B, H, S, hd)).astype(np.float32) * 2.0
    v = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    start = np.array([0, 5, 0, 10, 3, 17], np.int32)
    end = np.array([64, 33, 1, 10, 3 + n, 17 + 3 * n + 1], np.int32)
    mask = rng.random((B, S)) < 0.8
    mask[2, 0] = mask[4, 3] = True
    lo, hi = da.split_bounds(torch.from_numpy(start), torch.from_numpy(end), n)
    mask[0, int(lo[0, min(1, n - 1)]):int(hi[0, min(1, n - 1)])] = False
    kq, ks = _quant_rows(jnp.asarray(k))
    vq, vs = _quant_rows(jnp.asarray(v))
    j = np.arange(S)
    ok = (j >= start[:, None]) & (j < end[:, None]) & mask
    bias = jnp.where(jnp.asarray(ok[:, None, None, :]), 0.0, -1e9).astype(jnp.float32)
    want = np.array(_quant_cache_attention(jnp.asarray(q), kq, ks, vq, vs, bias))[:, :, 0]
    want[~ok.any(1)] = 0.0
    kq_t, ks_t, vq_t, vs_t = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
    got = da.decode_cache_attention_split_reference(
        torch.from_numpy(q[:, :, 0]), kq_t, vq_t, torch.from_numpy(start), torch.from_numpy(end),
        n, key_mask=torch.from_numpy(mask), scales=(ks_t, vs_t))
    assert got.shape == (B, H, hd) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_layout_check_refuses_what_the_bulk_copies_cannot_take():
    B, H, S, hd = 2, 3, 64, 32
    q = torch.zeros(B, H, hd)
    k = torch.zeros(B, H, S, hd)
    start = torch.zeros(B, dtype=torch.int32)
    end = torch.full((B,), S, dtype=torch.int32)
    da._check(q, k, k, start, end, None)
    strided = torch.zeros(B, H, S, 2 * hd)[..., :hd]  # rows 2 hd apart
    with pytest.raises(ValueError, match="contiguous run"):
        da._check(q, strided, strided, start, end, None)
    kq = torch.zeros(B, H, S, hd, dtype=torch.int8)
    scale = torch.zeros(B, H, S)
    da._check(q, kq, kq, start, end, None, scales=(scale, scale))
    odd = torch.zeros(B, H, S + 2)[..., 1:S + 1]  # rows starting 4 bytes off 16
    with pytest.raises(ValueError, match="start on 16 bytes"):
        da._check(q, kq, kq, start, end, None, scales=(odd, scale))


@pytest.mark.parametrize("S", [63, 64, 1023])
def test_aligned_rows_pads_scales_whose_rows_do_not_start_on_16_bytes(S):
    t = torch.randn(2, 3, S)
    got = da._aligned_rows(t)
    assert torch.equal(got, t) and da._rows_aligned(got)
    assert (got.data_ptr() == t.data_ptr()) == (S % 4 == 0)  # a copy only where needed
