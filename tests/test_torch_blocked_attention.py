"""The blocked attention of neko_tpu_torch (ops/blocked_attention.py) against
neko_tpu's blocked kernels on the CPU.

The JAX package's pallas_calls run in interpret mode here (fp32, exact), as
its own tests run them.  The port's plain versions -- what its wrappers run
on a CPU tensor, and what its CUDA kernels are held to on the card -- are
held to them in fp32 on left-padded, short and empty rows:

* plain #6 (`blocked_fwd_reference`) against `_pallas_fwd`: o, m and l on
  the rows that see a key (the JAX stats [B, H//g, g, S] reshaped to
  [B, H, S]);
* plain #7, #8 and #9 against `_pallas_dq`, `_pallas_bwd_fused` and
  `_pallas_dkv`, given the same (m, l, delta);
* `blocked_attention_qkv` forward and backward against `jax.vjp` of
  `blocked_attention_bsd`, through both backward routes;
* an S that is no multiple of 512 against neko_tpu's `xla_attention`.

Tolerances: outputs atol 1e-5, gradients atol 1e-4 (summation order only);
m and l also rtol 1e-5, since l sums up to S terms of order 1.  `do` is zero
on rows that see no key, as in tests/test_blocked_attention.py: there the
JAX kernel writes a finite average where the port writes 0.

Dropout is tested by mask injection (the TPU PRNG has no interpret mode):
the port's plain blocked attention with its Philox mask equals a jnp
attention given the same keep/scale matrix, and at S = 1024 it equals the
whole-head plain version at the same seed (one seed, one mask)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.ops import attention as jax_attn  # noqa: E402
from neko_tpu.ops import blocked_attention as jba  # noqa: E402

from neko_tpu_torch.ops import attention as attn  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import blocked_attention as ba  # noqa: E402

B, H, HD = 3, 4, 32
D = H * HD
OUT_TOL = dict(rtol=0.0, atol=1e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=0.0, atol=1e-4)
RATE = 0.1
SEED = 424242


@functools.lru_cache(maxsize=None)
def _inputs(S):
    """numpy q, k, v, do [B, S, D] fp32, start, end int32 [B], valid [B, S]:
    a left-padded row, a short row and an empty row; do is 0 where no key
    is seen."""
    rng = np.random.default_rng(S)
    q, k, v, do = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(4))
    start = np.array([S // 10, S - 37, S], np.int32)
    end = np.array([S, S, 0], np.int32)
    rows = np.arange(S)[None, :]
    valid = (rows >= start[:, None]) & (start < end)[:, None]
    return q, k, v, do * valid[..., None], start, end, valid


def _key_mask(S, start, end):
    """bool [B, S]: start <= col < end."""
    cols = np.arange(S)[None]
    return (cols >= start[:, None]) & (cols < end[:, None])


def _bhsd(x):
    """numpy [B, S, D] -> torch [B, H, S, hd] view."""
    return whk._heads4(torch.from_numpy(np.ascontiguousarray(x)), H)


def _bsd(t):
    """torch [B, H, S, hd] -> numpy [B, S, D]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1).numpy()


def _jax_stats(x, S):
    """[B, H, S] -> the JAX kernels' [B, H//g, g, S] (g = H here)."""
    return jnp.asarray(np.asarray(x).reshape(B, 1, H, S))


@functools.lru_cache(maxsize=None)
def _jax_forward(S):
    """(o [B, S, D], m, l, delta [B, H, S]) from the JAX #6 in interpret
    mode."""
    q, k, v, do, start, end, _ = _inputs(S)
    with jax.default_matmul_precision("highest"):
        o, m, l = jba._pallas_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(start), jnp.asarray(end),
                                  jnp.zeros((1,), jnp.int32), H, HD ** -0.5, 0.0)
    o = np.asarray(o)
    delta = (do * o).reshape(B, S, H, HD).sum(-1).transpose(0, 2, 1)
    return o, np.array(m).reshape(B, H, S), np.array(l).reshape(B, H, S), delta


@pytest.mark.parametrize("S", [1024, 1536])
def test_plain_forward_matches_the_jax_kernel(S):
    q, k, v, _, start, end, valid = _inputs(S)
    o, m, l, _ = _jax_forward(S)
    got_o, got_m, got_l = ba.blocked_fwd_reference(
        _bhsd(q), _bhsd(k), _bhsd(v), torch.from_numpy(start), torch.from_numpy(end))
    np.testing.assert_allclose(_bsd(got_o)[valid], o[valid], **OUT_TOL)
    rows = np.broadcast_to(valid[:, None, :], m.shape)
    np.testing.assert_allclose(got_m.numpy()[rows], m[rows], **STAT_TOL)
    np.testing.assert_allclose(got_l.numpy()[rows], l[rows], **STAT_TOL)
    # rows that see no key: o = 0, m = -1e30, l = 0
    assert not got_o.transpose(1, 2)[torch.from_numpy(~valid)].any()
    assert (got_m.numpy()[~rows] == np.float32(-1e30)).all() and not got_l.numpy()[~rows].any()


@pytest.mark.parametrize("S", [1024, 1536])
@pytest.mark.parametrize("kernel", ["dq", "fused", "dkv"])
def test_plain_backward_matches_the_jax_kernel(S, kernel):
    """Given the JAX forward's (m, l) and delta = rowsum(do * o)."""
    q, k, v, do, start, end, _ = _inputs(S)
    _, m, l, delta = _jax_forward(S)
    jax_fn, port_fn = {
        "dq": (jba._pallas_dq, ba.blocked_dq_reference),
        "fused": (jba._pallas_bwd_fused, ba.blocked_bwd_fused_reference),
        "dkv": (jba._pallas_dkv, ba.blocked_dkv_reference),
    }[kernel]
    with jax.default_matmul_precision("highest"):
        want = jax_fn(*(jnp.asarray(x) for x in (q, k, v, do)),
                      *(_jax_stats(x, S) for x in (m, l, delta)),
                      jnp.asarray(start), jnp.asarray(end), jnp.zeros((1,), jnp.int32),
                      H, HD ** -0.5, 0.0)
    got = port_fn(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(do),
                  *(torch.from_numpy(x) for x in (m, l, np.ascontiguousarray(delta))),
                  torch.from_numpy(start), torch.from_numpy(end))
    if kernel == "dq":
        want, got = [want], [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_bsd(g), np.asarray(w), **GRAD_TOL)


def _port_qkv(S, rate=0.0, seed=None, fn=ba.blocked_attention_qkv):
    """(out [B, S, D], dq, dk, dv as numpy [B, S, D]) of the port's qkv entry
    point on the CPU, with the test's do."""
    q, k, v, do, start, end, _ = _inputs(S)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).requires_grad_()
    out = fn(qkv, torch.from_numpy(start), torch.from_numpy(end), seed, heads=H,
             dropout_rate=rate)
    (g,) = torch.autograd.grad(out, (qkv,), torch.from_numpy(do))
    return (out.detach().numpy(), *np.split(g.numpy(), 3, axis=-1))


@pytest.mark.parametrize("route", ["fused", "three-pass"])
def test_qkv_matches_jax_vjp_of_blocked_attention_bsd(route, monkeypatch):
    S = 1536
    q, k, v, do, start, end, valid = _inputs(S)
    if route == "three-pass":
        monkeypatch.setattr(jba, "FUSED_MAX", 0)
        monkeypatch.setattr(ba, "FUSED_MAX", 0)
    calls = {n: getattr(ba, n) for n in ("blocked_attention_bwd_fused", "blocked_attention_dq")}
    seen = []
    for name, fn in calls.items():
        monkeypatch.setattr(ba, name, lambda *a, n=name, f=fn, **kw: seen.append(n) or f(*a, **kw))
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda *xs: jba.blocked_attention_bsd(*xs, jnp.asarray(start), jnp.asarray(end),
                                                  heads=H),
            *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    got_out, *got = _port_qkv(S)
    assert seen == ["blocked_attention_bwd_fused" if route == "fused" else "blocked_attention_dq"]
    np.testing.assert_allclose(got_out[valid], np.asarray(out)[valid], **OUT_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def _port_bsd(qkv, *args, **kwargs):
    """`blocked_attention_bsd` (the JAX signature) on the slices of qkv."""
    return ba.blocked_attention_bsd(*qkv.chunk(3, dim=-1), *args, **kwargs)


def test_ragged_length_matches_jax_xla_attention():
    """S = 1300: no multiple of the 512-wide tiles (the JAX kernels refuse
    it; the port masks the tail tile), through `blocked_attention_bsd`."""
    S = 1300
    q, k, v, do, start, end, valid = _inputs(S)
    key_mask = jnp.asarray(_key_mask(S, start, end))

    def ref(*xs):
        q4, k4, v4 = (x.reshape(B, S, H, HD).transpose(0, 2, 1, 3) for x in xs)
        return jax_attn.xla_attention(q4, k4, v4, key_mask).transpose(0, 2, 1, 3).reshape(B, S, D)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    got_out, *got = _port_qkv(S, fn=_port_bsd)
    np.testing.assert_allclose(got_out[valid], np.asarray(out)[valid], **OUT_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def test_dropout_equals_jnp_attention_with_the_same_mask(monkeypatch):
    S = 1536
    q, k, v, do, start, end, valid = _inputs(S)
    seed = torch.tensor([SEED], dtype=torch.int32)
    ks = jnp.asarray(ba.dropout_keep_scale(seed, B, H, S, RATE).numpy())
    allowed = jnp.asarray(np.tril(np.ones((S, S), bool))[None, None]
                          & _key_mask(S, start, end)[:, None, None, :])

    def ref(*xs):  # tests/test_blocked_attention.py's mask-injection reference
        q4, k4, v4 = (x.reshape(B, S, H, HD).transpose(0, 2, 1, 3) for x in xs)
        logits = jnp.einsum("bhqd,bhkd->bhqk", q4, k4) * HD ** -0.5
        p = jax.nn.softmax(jnp.where(allowed, logits, -1e9), axis=-1) * ks
        return jnp.einsum("bhqk,bhkd->bhqd", p, v4).transpose(0, 2, 1, 3).reshape(B, S, D)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    for fused_max in (S, 0):  # the fused route, then the three-pass one
        monkeypatch.setattr(ba, "FUSED_MAX", fused_max)
        got_out, *got = _port_qkv(S, RATE, seed)
        np.testing.assert_allclose(got_out[valid], np.asarray(out)[valid], **OUT_TOL)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def test_one_seed_gives_the_whole_head_dropout_at_s_1024():
    seed = torch.tensor([SEED], dtype=torch.int32)
    blocked = _port_qkv(1024, RATE, seed)
    whole = _port_qkv(1024, RATE, seed, fn=whk.whole_head_attention_qkv)
    valid = _inputs(1024)[-1]
    np.testing.assert_allclose(blocked[0][valid], whole[0][valid], **OUT_TOL)
    for g, w in zip(blocked[1:], whole[1:]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_dropout_keep_scale_is_the_plain_philox_on_the_cpu():
    seed = torch.tensor([SEED], dtype=torch.int32)
    got = ba.dropout_keep_scale(seed, 2, 3, 1100, RATE)
    assert torch.equal(got, whk.dropout_keep_scale_reference(seed, 2, 3, 1100, RATE))


@pytest.mark.parametrize("S", [1, 17, 130])
def test_dropout_keep_scale_at_S_is_the_corner_of_a_longer_mask(S):
    """The keep byte depends on (seed, b, h, row, col) alone: the blocked
    mask (#10) at S is the top-left [S, S] corner of the one at 200."""
    seed = torch.tensor([SEED], dtype=torch.int32)
    got = ba.dropout_keep_scale(seed, 2, 3, S, RATE)
    full = whk.dropout_keep_scale_reference(seed, 2, 3, 200, RATE)
    assert torch.equal(got, full[:, :, :S, :S])


def test_dispatch_by_length_and_no_kernel_launch_on_the_cpu(monkeypatch):
    assert ba.supported(2048, 32) and ba.supported(8192, 128)
    assert ba.supported(3000, 64) and ba.supported(2048, 48)
    assert not ba.supported(2048, 256) and attn.wide_heads(256)
    assert ba.supported(3000, 32) and not ba.supported(0, 32)
    counters = [whk.whole_head_attention, whk.whole_head_attention_bwd, whk.dropout_keep_scale,
                ba.blocked_attention_fwd, ba.blocked_attention_bwd_fused,
                ba.blocked_attention_dq, ba.blocked_attention_dkv]
    before = [c.launches for c in counters]
    taken = []
    for name, mod in (("whole_head_attention_qkv", whk), ("blocked_attention_qkv", ba)):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, n=name, f=fn, **kw: taken.append(n) or f(*a, **kw))
    for S in (1024, 1025):
        rng = np.random.default_rng(S)
        qkv = torch.from_numpy(rng.standard_normal((1, S, 3 * 64)).astype(np.float32))
        qkv.requires_grad_()
        out = attn.attention_qkv(qkv, torch.ones(1, S, dtype=torch.bool), heads=2,
                                 seed=torch.tensor([3], dtype=torch.int32), rate=RATE)
        out.sum().backward()
        assert torch.isfinite(qkv.grad).all()
    assert taken == ["whole_head_attention_qkv", "blocked_attention_qkv"]
    assert [c.launches for c in counters] == before
