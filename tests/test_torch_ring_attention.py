"""The ring attention of neko_tpu_torch (ops/ring_kernel.py, ops/ring_attention.py,
parallel/mesh.py) against neko_tpu's on the CPU.

The JAX package's ring pallas_calls run in interpret mode here (fp32, exact),
as its own tests run them; its ring schedule runs under `shard_map` on the
virtual CPU devices.  The port's plain versions -- what its wrappers run on a
CPU tensor, and what its CUDA kernels are held to on the card -- are held to
them in fp32, H = 2, hd = 64, on a full row and left-padded rows:

* plain #11, #12, #13 (`ring_partial_*_reference`) against `_partial_fwd`,
  `_partial_dq`, `_partial_dkv` for a diagonal, a past and a future pair, on
  the rows that see a key of the pair (there the JAX kernel leaves a finite
  average and its count, the port m = -1e30, l = 0, acc = 0);
* `ring_attention_bsd` forward and `torch.autograd` gradients against
  neko_tpu's `ring_attention_bsd` under `shard_map` and its `jax.vjp`, over
  2 and 4 shards;
* the plain ring (`ring_attention.ring_attention`) against
  `sequence_sharded_attention`;
* dropout by an injected keep/scale matrix (the TPU PRNG has no interpret
  mode): the ring with the port's Philox mask equals a jnp attention given
  the same matrix, and `blocked_attention_bsd` at the same seed;
* the mesh, the dispatch and what raises.

The model under a seq mesh and the process-group schedule are in
tests/test_torch_ring_model.py.

Tolerances (fp32, summation order only): outputs atol 2e-5 (the JAX tests'),
partial accumulators and row sums rtol 1e-5 + atol 1e-5, gradients atol 1e-4;
the model as tests/test_torch_train.py holds it."""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.ops import ring_attention as jra  # noqa: E402
from neko_tpu.ops import ring_kernel as jrk  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.ops import attention as attn  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import blocked_attention as ba  # noqa: E402
from neko_tpu_torch.ops import ring_attention as ra  # noqa: E402
from neko_tpu_torch.ops import ring_kernel as rk  # noqa: E402
from neko_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from neko_tpu_torch.training import train_state as ts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
H, HD = 2, 64
D = H * HD
OUT_TOL = dict(rtol=0.0, atol=2e-5)
STAT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=0.0, atol=1e-4)
RATE = 0.1
SEED = 424242


@functools.lru_cache(maxsize=None)
def _inputs(n, S_l, B=2):
    """numpy q, k, v, do [B, n * S_l, D] fp32, global start, end int32 [B],
    valid [B, S]: a full row, then rows left-padded from inside shard 1 and
    shard 0; do is 0 where no key is seen."""
    S = n * S_l
    rng = np.random.default_rng(n * 1000 + S_l)
    q, k, v, do = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(4))
    start = np.array([0, S_l + S_l // 3, S_l // 2][:B], np.int32)
    end = np.full(B, S, np.int32)
    valid = np.arange(S)[None, :] >= start[:, None]
    return q, k, v, do * valid[..., None], start, end, valid


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bhsd(x):
    """numpy [B, S, D] -> torch [B, H, S, hd] view."""
    return whk._heads4(_t(x), H)


def _bsd(t):
    """torch [B, H, S, hd] -> numpy [B, S, D]."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], -1).numpy()


def _key_mask(S, start, end):
    cols = np.arange(S)[None]
    return (cols >= start[:, None]) & (cols < end[:, None])


def _port_ring(n, S_l, rate=0.0, seed=None, B=2):
    """(out, dq, dk, dv as numpy [B, S, D], L [n, B, H, S_l]) of the port's
    `ring_attention_bsd` over n shards on the CPU, with the test's do."""
    q, k, v, do, start, end, _ = _inputs(n, S_l, B)
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = rk.ring_attention_bsd(*xs, _t(start), _t(end), seed, n_shards=n, heads=H,
                                dropout_rate=rate)
    L = out.grad_fn.saved_tensors[4]
    grads = torch.autograd.grad(out, xs, _t(do))
    return (out.detach().numpy(), *(g.numpy() for g in grads), L)


# ------------------------------------------------ per-pair plain versions
PAIRS = {"diagonal": (1, 1), "past": (2, 0), "straddles start": (2, 1), "future": (0, 2)}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plain_pair_versions_match_the_jax_kernels(pair):
    n, S_l = 3, 128
    i, j = PAIRS[pair]
    q, k, v, do, start, end, _ = _inputs(n, S_l)
    *_, L_all = _port_ring(n, S_l)
    rows, cols = slice(i * S_l, (i + 1) * S_l), slice(j * S_l, (j + 1) * S_l)
    qi, kj, vj, doi = q[:, rows], k[:, cols], v[:, cols], do[:, rows]
    at = (i * S_l, j * S_l, _t(start), _t(end))
    acc, m, l = rk.ring_partial_fwd_reference(_bhsd(qi), _bhsd(kj), _bhsd(vj), *at)
    seen = (l > 0).numpy()  # rows that see a key of the pair

    offs = jnp.asarray([i * S_l, j * S_l], jnp.int32)
    rest = (offs, jnp.asarray(start), jnp.asarray(end), jnp.zeros((1,), jnp.int32),
            H, HD ** -0.5, 0.0, n, n)
    with jax.default_matmul_precision("highest"):
        o_w, m_w, l_w = jrk._partial_fwd(jnp.asarray(qi), jnp.asarray(kj), jnp.asarray(vj), *rest)
    m_w, l_w = (np.asarray(x).reshape(2, H, S_l) for x in (m_w, l_w))
    rows_bsd = np.repeat(seen.transpose(0, 2, 1), HD, axis=-1)  # [B, S_l, D]
    np.testing.assert_allclose(_bsd(acc)[rows_bsd], np.asarray(o_w)[rows_bsd], **STAT_TOL)
    np.testing.assert_allclose(m.numpy()[seen], m_w[seen], **STAT_TOL)
    np.testing.assert_allclose(l.numpy()[seen], l_w[seen], **STAT_TOL)
    assert (m.numpy()[~seen] == np.float32(-1e30)).all() and not acc[_t(~seen)].any()
    assert seen.any() == rk.pair_visible(i * S_l, j * S_l, S_l)
    if pair == "future":  # the JAX kernel's zero trip count: nothing at all
        assert not np.asarray(o_w).any() and not np.asarray(l_w).any()

    # the backward partials from the ring's log-sum-exp and delta
    L = L_all[i]
    delta = _t(np.random.default_rng(i * 7 + j).standard_normal((2, H, S_l)).astype(np.float32))
    stats = [jnp.asarray(x.numpy().reshape(2, 1, H, S_l)) for x in (L, delta)]
    bwd_in = [jnp.asarray(x) for x in (qi, kj, vj, doi)]
    with jax.default_matmul_precision("highest"):
        dq_w = jrk._partial_dq(*bwd_in, *stats, *rest)
        dk_w, dv_w = jrk._partial_dkv(*bwd_in, *stats, *rest)
    port_in = (_bhsd(qi), _bhsd(kj), _bhsd(vj), _bhsd(doi), L, delta, *at)
    dq = rk.ring_partial_dq_reference(*port_in)
    dk, dv = rk.ring_partial_dkv_reference(*port_in)
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_bsd(got), np.asarray(want), **GRAD_TOL)


# ------------------------------------------------------ the ring as a whole
def _jax_ring(n, q, k, v, start, end):
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    fn = shard_map(
        lambda q, k, v, st, en: jrk.ring_attention_bsd(q, k, v, st, en, axis_name="seq",
                                                       n_shards=n, heads=H),
        mesh=mesh, in_specs=(P(None, "seq"), P(None, "seq"), P(None, "seq"), P(), P()),
        out_specs=P(None, "seq"), check_vma=False)
    return fn(q, k, v, start, end)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring_under_shard_map_with_gradients(n):
    S_l = 128
    q, k, v, do, start, end, valid = _inputs(n, S_l)
    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(
            lambda *xs: _jax_ring(n, *xs, jnp.asarray(start), jnp.asarray(end)),
            *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    got_out, *got, _ = _port_ring(n, S_l)
    np.testing.assert_allclose(got_out[valid], np.asarray(out)[valid], **OUT_TOL)
    assert not got_out[~valid].any()  # rows that see no key: 0 in the port
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


def test_plain_ring_matches_jax_sequence_sharded_attention():
    n, S_l = 4, 128
    q, k, v, _, start, end, valid = _inputs(n, S_l)
    km = _key_mask(n * S_l, start, end)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("seq",))
    q4, k4, v4 = (x.reshape(2, n * S_l, H, HD).transpose(0, 2, 1, 3) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        want = jra.sequence_sharded_attention(*(jnp.asarray(x) for x in (q4, k4, v4)), mesh,
                                              key_mask=jnp.asarray(km))
    got = ra.ring_attention(_bhsd(q), _bhsd(k), _bhsd(v), n, key_mask=_t(km))
    rows = np.broadcast_to(valid[:, None, :, None], got.shape)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows], **OUT_TOL)
    ring_out = _port_ring(n, S_l)[0]  # and the kernels' schedule computes the same
    np.testing.assert_allclose(ring_out[valid], _bsd(got)[valid], **OUT_TOL)
    with pytest.raises(ValueError):
        ra.ring_attention(_bhsd(q), _bhsd(k), _bhsd(v), 3)


def test_dropout_equals_jnp_attention_and_blocked_attention_with_the_same_mask():
    n, S_l = 4, 128
    S = n * S_l
    q, k, v, do, start, end, valid = _inputs(n, S_l)
    seed = torch.tensor([SEED], dtype=torch.int32)
    ks = whk.dropout_keep_scale_reference(seed, 2, H, S, RATE)
    allowed = jnp.asarray(np.tril(np.ones((S, S), bool))[None, None]
                          & _key_mask(S, start, end)[:, None, None, :])

    def ref(*xs):  # tests/test_blocked_attention.py's mask-injection reference
        q4, k4, v4 = (x.reshape(2, S, H, HD).transpose(0, 2, 1, 3) for x in xs)
        logits = jnp.einsum("bhqd,bhkd->bhqk", q4, k4) * HD ** -0.5
        p = jax.nn.softmax(jnp.where(allowed, logits, -1e9), axis=-1) * jnp.asarray(ks.numpy())
        return jnp.einsum("bhqk,bhkd->bhqd", p, v4).transpose(0, 2, 1, 3).reshape(2, S, D)

    with jax.default_matmul_precision("highest"):
        out, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    got_out, *got, _ = _port_ring(n, S_l, RATE, seed)
    np.testing.assert_allclose(got_out[valid], np.asarray(out)[valid], **OUT_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)
    # one seed, one mask: the blocked attention at the same S drops the same elements
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    blocked = ba.blocked_attention_bsd(*xs, _t(start), _t(end), seed, heads=H, dropout_rate=RATE)
    grads = torch.autograd.grad(blocked, xs, _t(do))
    np.testing.assert_allclose(got_out[valid], blocked.detach().numpy()[valid], **OUT_TOL)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g, w.numpy(), **GRAD_TOL)
    # the plain ring with the same matrix, and the pair windows of the mask
    plain = ra.ring_attention(_bhsd(q), _bhsd(k), _bhsd(v), n,
                              key_mask=_t(_key_mask(S, start, end)), keep_scale=ks)
    np.testing.assert_allclose(_bsd(plain)[valid], got_out[valid], **OUT_TOL)
    window = whk.dropout_keep_scale_reference(seed, 2, H, None, RATE, rows=(S_l, 2 * S_l),
                                              cols=(3 * S_l - 5, S))
    assert torch.equal(window, ks[:, :, S_l:2 * S_l, 3 * S_l - 5:])


def test_ragged_shards_and_the_qkv_layout_match_blocked_attention():
    """S_local = 150: offsets off the kernels' 32-key tiles and the plain
    versions' 512-wide ones; q, k, v as slices of one projection output."""
    n, S_l = 3, 150
    q, k, v, do, start, end, valid = _inputs(n, S_l)
    seed = torch.tensor([SEED], dtype=torch.int32)
    res = []
    for fn, kw in ((rk.ring_attention_qkv, {"n_shards": n}), (ba.blocked_attention_qkv, {})):
        qkv = _t(np.concatenate([q, k, v], -1)).requires_grad_()
        out = fn(qkv, _t(start), _t(end), seed, heads=H, dropout_rate=RATE, **kw)
        (g,) = torch.autograd.grad(out, (qkv,), _t(do))
        res.append((out.detach().numpy(), g.numpy()))
    np.testing.assert_allclose(res[0][0][valid], res[1][0][valid], **OUT_TOL)
    np.testing.assert_allclose(res[0][1], res[1][1], **GRAD_TOL)


def test_merging_an_empty_partial_changes_nothing_and_stays_finite():
    g = torch.Generator().manual_seed(0)
    m, l = torch.randn(2, 3, 8, generator=g), torch.rand(2, 3, 8, generator=g) + 0.1
    acc = torch.randn(2, 3, 8, 4, generator=g)
    m[0, 0, :2], l[0, 0, :2], acc[0, 0, :2] = -1e30, 0.0, 0.0  # rows that saw no key yet
    want = (m.clone(), l.clone(), acc.clone())
    empty = (torch.full_like(m, -1e30), torch.zeros_like(l), torch.zeros_like(acc))
    rk.merge_partial(m, l, acc, *empty)
    for got, w in zip((m, l, acc), want):
        assert torch.equal(got, w)
    # an empty state takes the partial as it is
    state = tuple(t.clone() for t in empty)
    rk.merge_partial(*state, *want)
    for got, w in zip(state, want):
        assert torch.isfinite(got).all() and torch.equal(got, w)


# ------------------------------------------------------------- the model
LONG = dict(embed_dim=128, layers=2, heads=2, context_len=512, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _long_arrays():
    rng = np.random.default_rng(11)
    examples = [{"text": rng.integers(0, 256, 500)},
                {"continuous_obs": rng.standard_normal((30, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (30, 2)).astype(np.float32)},
                {"text": rng.integers(0, 256, 150)}]
    arrays = JaxPacker(JaxConfig(**LONG)).pack_batch(examples)
    arrays.pop("lengths")
    return arrays


# ------------------------------------------- mesh, dispatch and the raises
def test_mesh_axes_context_and_what_is_not_ported():
    mesh = pmesh.create_mesh(data=1, seq=4, model=1)
    assert mesh.axis_names == ("data", "seq", "model")
    assert mesh.shape == {"data": 1, "seq": 4, "model": 1}
    assert mesh.seq_group is None  # torch.distributed is not initialised: shards on the device
    assert pmesh.seq_axis_size(mesh) == 4 and pmesh.seq_axis_size(None) == 1
    assert pmesh.seq_axis_size(pmesh.create_mesh(data=1)) == 1
    assert pmesh.create_mesh(seq=2).shape["data"] == 1  # data=None: what the others leave
    assert pmesh.active_mesh() is None and attn.seq_shards() == 1
    with mesh:
        assert pmesh.active_mesh() is mesh and attn.seq_shards() == 4
        with pmesh.create_mesh(data=1, model=1):
            assert attn.seq_shards() == 1
        assert attn.seq_shards() == 4
    assert pmesh.active_mesh() is None
    # no process group to lay them over ('pipe' is ported: over ranks alone)
    for bad in (dict(model=2), dict(data=2), dict(pipe=2)):
        with pytest.raises(ValueError, match="multihost"):
            pmesh.create_mesh(**bad)
    with pytest.raises(AssertionError):  # as in neko_tpu: pipe does not compose with seq
        pmesh.create_mesh(pipe=2, seq=2)
    # the one-device shards whatever group there is; an axis the grid lacks is LOCAL
    assert pmesh.device_mesh(4) == mesh and mesh.axis("pipe").size == 1
    assert pmesh.seq_ranks(mesh) == 1


def test_dispatch_and_the_raises(monkeypatch):
    assert rk.supported(2048, 32) and rk.supported(150, 128) and rk.supported(128, 48)
    assert not rk.supported(128, 256)
    assert not rk.supported(0, 32)
    assert rk.pair_visible(256, 0, 128) and rk.pair_visible(128, 255, 128)
    assert not rk.pair_visible(128, 256, 128)
    assert not attn.packed_ring_ok(512, 64, 2)  # no mesh
    mesh = pmesh.create_mesh(data=1, seq=4)
    with mesh:
        assert attn.packed_ring_ok(512, 64, 2) and attn.packed_ring_ok(16384, 32, 24)
        assert not attn.packed_ring_ok(510, 64, 2) and not attn.packed_ring_ok(512, 256, 2)

    counters = [rk.ring_partial_fwd, rk.ring_partial_dq, rk.ring_partial_dkv,
                ba.blocked_attention_fwd, whk.whole_head_attention]
    before = [c.launches for c in counters]
    taken = []
    for name, mod in (("ring_attention_qkv", rk), ("blocked_attention_qkv", ba),
                      ("whole_head_attention_qkv", whk)):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, n=name, f=fn, **kw: taken.append(n) or f(*a, **kw))
    cfg = ModelConfig(**dict(LONG, layers=1, dropout=0.1))
    batch = to_device_batch(_long_arrays(), "cpu")

    def step(c, mesh=None):
        ctx = ts.TrainContext(c, ts.OptimizerConfig(), device="cpu", mesh=mesh)
        return ctx.train_step(ctx.init_state(), batch)[1].item()

    assert np.isfinite(step(cfg, mesh)) and taken == ["ring_attention_qkv"]
    assert np.isfinite(step(cfg)) and taken[1:] == ["whole_head_attention_qkv"]
    assert [c.launches for c in counters] == before  # no kernel launch on CPU tensors

    with pytest.raises(ValueError):  # context 512 does not split over 3 shards
        ts.TrainContext(cfg, ts.OptimizerConfig(), device="cpu",
                        mesh=pmesh.create_mesh(data=1, seq=3))
    model = convert.build_model(cfg, convert.init_state_dict(cfg, 0), device="cpu")
    with pmesh.create_mesh(seq=3), pytest.raises(ValueError):
        model(batch, train=True, compute_loss=True, generator=torch.Generator().manual_seed(0))
    bad_hd = ModelConfig(**dict(LONG, embed_dim=256, heads=1))  # hd 256: over 128, mesh or not
    with mesh, pytest.raises(NotImplementedError):
        convert.build_model(bad_hd, convert.init_state_dict(bad_hd, 0), device="cpu")(
            batch, train=True, compute_loss=True, generator=torch.Generator().manual_seed(0))
    x = torch.zeros(1, 512, D)
    bounds = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(ValueError):
        rk.ring_attention_bsd(x, x, x, bounds, bounds + 512, n_shards=3, heads=H)
    x256 = torch.zeros(1, 512, 256)
    with pytest.raises(ValueError):  # hd 256: over the kernels' 128
        rk.ring_attention_bsd(x256, x256, x256, bounds, bounds + 512, n_shards=4, heads=1)
    with pytest.raises(ValueError):  # no active seq axis
        attn.sequence_parallel_attention_bsd(x, x, x, torch.ones(1, 512, dtype=torch.bool),
                                             heads=H)
    with mesh:
        out = attn.sequence_parallel_attention_bsd(
            x, x, x, torch.ones(1, 512, dtype=torch.bool), heads=H)
    assert out.shape == (1, 512, D)
    # a 'seq' axis over the ranks of a process group: the ring runs there
    # (the gloo test) and so does the train step (tests/test_torch_seq_ranks.py);
    # every leaf is replicated over 'seq', and the context must split over it
    seq_axis = pmesh.Axis(4, 1, object())
    ranks = pmesh.Mesh(("data", "seq", "model"), (1, 4, 1), seq_axis.group,
                       (pmesh.LOCAL, seq_axis, pmesh.LOCAL))
    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(), device="cpu", mesh=ranks)
    assert ctx.seq_axis is seq_axis and ctx.layout == ts.TrainContext(
        cfg, ts.OptimizerConfig(), device="cpu").layout
    with pytest.raises(ValueError):
        ts.TrainContext(cfg.replace(context_len=cfg.context_len + 2), ts.OptimizerConfig(),
                        device="cpu", mesh=ranks)
