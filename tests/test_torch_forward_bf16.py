"""The plain forwards that the bf16 attention tile is held to on the card, in
bf16, against neko_tpu's kernels on the CPU.

The tensor-core forward (csrc/attention_fwd.cuh) rounds p * keep to bf16
before the value product, as neko_tpu does.  chip_smoke.py and
tests/test_torch_attention_cuda.py hold it to the port's plain versions on
the same bf16 inputs, so those plain versions are pinned here to neko_tpu's
Pallas kernels in interpret mode, on the same bf16 inputs:

* plain #6 (`blocked_fwd_reference`) against `_fwd_kernel` (via
  `_pallas_fwd`): o, m and l;
* plain #11 (`ring_partial_fwd_reference`) against `_ring_fwd_kernel` (via
  `_partial_fwd`) on a diagonal pair, a past pair and the pair whose kv shard
  holds a row's `start`: the unnormalized acc, m and l;

at hd 16 (configs/smoke_offline.sh's width) and hd 32 (the flagship's), on a
left-padded row and a full one, without dropout and with an injected
keep/scale.  The TPU PRNG has no interpret mode, so the keep mask is
injected: `_keep_scale_blk` is swapped for a jnp hash of (seed, b, h, row,
col), and the port's plain versions get the same matrix.  Both sides round
exp(s - m) * keep to bf16 over the same 512-wide tiles and sum in fp32, so
they differ by fp32 summation order and exp's rounding, which may flip a
rounding to bf16 by one ulp.  Tolerances on the rows that see a key: o 1e-2
plus one bf16 ulp relative; acc the same scaled by l (acc is not divided by
it); m 1e-5; l 1e-5 plus 1e-4 relative."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops import blocked_attention as jba  # noqa: E402
from neko_tpu.ops import ring_kernel as jrk  # noqa: E402

from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import blocked_attention as ba  # noqa: E402
from neko_tpu_torch.ops import ring_kernel as rk  # noqa: E402

B, H = 2, 4
S_BLOCKED = 1024
N_SHARDS, S_LOCAL = 4, 512  # 512-row shards: the JAX ring kernel's 512-wide tiles
RATE, SEED = 0.1, 1234
ULP = 2.0 ** -7  # one bf16 ulp, relative
STAT_TOL = {"m": dict(atol=1e-5, rtol=0.0), "l": dict(atol=1e-5, rtol=1e-4)}
# (q shard, kv shard): diagonal, past, the kv shard that holds row 0's start
PAIRS = {"ring diagonal": (1, 1), "ring past": (3, 0), "ring straddles start": (2, 1)}


def _inputs(S, hd):
    """bf16 torch q, k, v [B, S, H * hd] (numpy-seeded) and start, end int32
    [B]: a row left-padded into shard 1 and a full row."""
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H * hd)).astype(np.float32))
               .bfloat16() for _ in range(3))
    start = np.array([S // 4 + 88, 0], np.int32)
    end = np.full(B, S, np.int32)
    return q, k, v, start, end


def _keep_bytes(seed, bh, rows, cols):
    """uint32 keep bytes of (seed, b * H + h, row, col), a 32-bit hash; the
    same arithmetic in numpy (wrapping uint32) and in jnp."""
    xp = jnp if isinstance(rows, jax.Array) else np
    u = xp.uint32
    x = (rows.astype(u) * u(0x9E3779B1)) ^ (cols.astype(u) * u(0x85EBCA77))
    x = x ^ (xp.asarray(bh).astype(u) * u(0xC2B2AE3D)) ^ xp.asarray(seed).astype(u)
    x = x ^ (x >> u(15))
    x = x * u(0x2C1B3C6D)
    x = x ^ (x >> u(12))
    return (x >> u(8)) & u(0xFF)


def _jax_keep_scale_blk(seed, b, h, qi, ki, n_heads, nq, nk, Bq, Bk, dropout_rate):
    """Stands in for neko_tpu's `_keep_scale_blk` inside its kernels: the
    keep/scale of rows [qi * Bq, +Bq) and columns [ki * Bk, +Bk) (global)."""
    q8 = whk.keep_threshold(dropout_rate)
    rows = qi * Bq + jax.lax.broadcasted_iota(jnp.int32, (Bq, Bk), 0)
    cols = ki * Bk + jax.lax.broadcasted_iota(jnp.int32, (Bq, Bk), 1)
    keep = (_keep_bytes(seed, b * n_heads + h, rows, cols) >= q8).astype(jnp.float32)
    return keep * (1.0 / (1.0 - q8 / 256.0))


def _port_keep_scale(rows, cols):
    """fp32 [B, H, len(rows), len(cols)]: the same keep/scale for the port."""
    q8 = whk.keep_threshold(RATE)
    bh = np.arange(B * H).reshape(B, H, 1, 1)
    keep = _keep_bytes(SEED, bh, np.asarray(rows)[:, None], np.asarray(cols)[None, :]) >= q8
    return torch.from_numpy(keep.astype(np.float32)) * whk.survivor_scale(q8)


def _np(t):
    return t.float().numpy()


def _jnp(t):
    return jnp.asarray(_np(t), jnp.bfloat16)


def _bsd(t):
    """[B, H, S, hd] -> numpy fp32 [B, S, H * hd]."""
    return _np(t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1))


def _close(got, want, rows, scale=1.0):
    """|got - want| <= (1e-2 + ULP |want| / scale) * scale on `rows`."""
    got, want = got[rows], want[rows]
    scale = np.broadcast_to(scale, rows.shape)[rows] if np.ndim(scale) else scale
    excess = np.abs(got - want) - 1e-2 * scale - ULP * np.abs(want)
    assert excess.max() <= 0, f"max abs diff {np.abs(got - want).max():.3e}"


@pytest.fixture
def injected_keep(monkeypatch):
    monkeypatch.setattr(jba, "_keep_scale_blk", _jax_keep_scale_blk)
    monkeypatch.setattr(jrk, "_keep_scale_blk", _jax_keep_scale_blk)


@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("case", ["blocked"] + sorted(PAIRS))
def test_plain_bf16_forward_matches_the_jax_kernel(case, dropout, hd, injected_keep):
    rate = RATE if dropout else 0.0
    S = S_BLOCKED if case == "blocked" else N_SHARDS * S_LOCAL
    q, k, v, start, end = _inputs(S, hd)
    jax_rest = (jnp.asarray(start), jnp.asarray(end), jnp.asarray([SEED], jnp.int32))
    port_bounds = (torch.from_numpy(start), torch.from_numpy(end))
    if case == "blocked":
        with jax.default_matmul_precision("highest"):
            o_w, m_w, l_w = jba._pallas_fwd(_jnp(q), _jnp(k), _jnp(v), *jax_rest, H, hd ** -0.5,
                                            rate)
        ks = _port_keep_scale(np.arange(S), np.arange(S)) if dropout else None
        o, m, l = ba.blocked_fwd_reference(*(whk._heads4(t, H) for t in (q, k, v)),
                                           *port_bounds, None, ks)
        assert o.dtype == torch.bfloat16
        o_w = np.asarray(o_w.astype(jnp.float32))
        rows = np.arange(S)[None, :] >= start[:, None]  # [B, S]
        _close(_bsd(o), o_w, np.repeat(rows[..., None], H * hd, axis=-1))
    else:
        i, j = PAIRS[case]
        q_off, k_off = i * S_LOCAL, j * S_LOCAL
        qi, kj, vj = q[:, q_off:q_off + S_LOCAL], k[:, k_off:k_off + S_LOCAL], \
            v[:, k_off:k_off + S_LOCAL]
        offs = jnp.asarray([q_off, k_off], jnp.int32)
        with jax.default_matmul_precision("highest"):
            o_w, m_w, l_w = jrk._partial_fwd(_jnp(qi), _jnp(kj), _jnp(vj), offs, *jax_rest, H,
                                             hd ** -0.5, rate, N_SHARDS, N_SHARDS)
        ks = (_port_keep_scale(np.arange(q_off, q_off + S_LOCAL),
                               np.arange(k_off, k_off + S_LOCAL)) if dropout else None)
        acc, m, l = rk.ring_partial_fwd_reference(*(whk._heads4(t, H) for t in (qi, kj, vj)),
                                                  q_off, k_off, *port_bounds, None, ks)
        assert acc.dtype == torch.float32
        o_w = np.asarray(o_w)
        rows = (_np(l) > 0).transpose(0, 2, 1)  # [B, S_local, H]: rows that see a key
        l_bsd = np.repeat(np.maximum(_np(l), 1.0).transpose(0, 2, 1), hd, axis=-1)
        _close(_bsd(acc), o_w, np.repeat(rows, hd, axis=-1), l_bsd)
        S = S_LOCAL
    m_w, l_w = (np.asarray(x).reshape(B, H, S) for x in (m_w, l_w))
    seen = _np(l) > 0
    assert seen.any()
    for name, got, want in (("m", m, m_w), ("l", l, l_w)):
        np.testing.assert_allclose(_np(got)[seen], want[seen], **STAT_TOL[name], err_msg=name)
    # rows that see no key: m = -1e30, l = 0 (and o or acc 0)
    assert (_np(m)[~seen] == np.float32(-1e30)).all() and not _np(l)[~seen].any()
    out = o if case == "blocked" else acc
    assert not _np(out)[np.broadcast_to(~seen[..., None], out.shape)].any()


def test_the_injected_keep_mask_drops_at_the_rate():
    keep = _port_keep_scale(np.arange(512), np.arange(512)) > 0
    share = keep.double().mean().item()
    expected = 1.0 - whk.keep_threshold(RATE) / 256.0
    assert abs(share - expected) < 5 * (expected * (1 - expected) / keep.numel()) ** 0.5
