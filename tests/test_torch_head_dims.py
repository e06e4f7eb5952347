"""Head dims that neko_tpu runs and the port's kernels are not compiled for,
against neko_tpu on the CPU (weights carried across by convert.py):

* a train step (loss and every gradient) at configs/smoke_offline.sh's
  width, 64d / 2 layers / 4 heads (hd 16), k = 128, dropout 0, against
  `jax.value_and_grad` of neko_tpu's NekoModel, fp32: loss within 1e-5,
  gradients within rtol 1e-4 / atol 1e-6 (summation order), as
  test_torch_train.py holds hd 32;
* a prefill and four decode steps at the same width: logits within 1e-4;
* hd 48 (96d, 2 heads), which the kernels' wrappers zero-pad to 64: the same
  train step check, and every wrapper on padded inputs equal to its plain
  version at hd 48 (zero columns change no score);
* the port's plain backwards at hd 16 in bf16 against neko_tpu's blocked and
  ring Pallas kernels in interpret mode, as test_torch_blocked_attention.py
  and test_torch_ring_attention.py hold them at hd 32 / 64 in fp32.  Both
  sides round p * keep and ds to bf16 before their products, sum in fp32
  and round the gradients to bf16, so they differ where an fp32 sum taken
  in another order lands on the other side of a rounding boundary: one bf16
  ulp (measured: at most 4.9e-4, on values near 0.1, in about 1 of 4,000
  values).  Tolerance: one bf16 ulp relative plus 1e-3 absolute.

On the CPU neko_tpu runs its XLA attention (any hd), and the port runs its
kernels' plain versions behind the same wrappers (and padding) the card
runs."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.ops import blocked_attention as jba  # noqa: E402
from neko_tpu.ops import ring_kernel as jrk  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.ops import attention as attn  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import blocked_attention as ba  # noqa: E402
from neko_tpu_torch.ops import decode_attention as da  # noqa: E402
from neko_tpu_torch.ops import ring_kernel as rk  # noqa: E402

# configs/smoke_offline.sh's width (64d, 4 heads: hd 16) at k = 128
SMOKE = dict(embed_dim=64, layers=2, heads=4, context_len=128, max_patches=4,
             dtype="float32", text_tokens=256, continuous_tokens=64,
             discrete_tokens=64, dropout=0.0)
ODD = dict(SMOKE, embed_dim=96, heads=2)  # hd 48
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-3)


def _arrays(shape, seed=0):
    rng = np.random.default_rng(seed)
    examples = [{"text": rng.integers(0, 256, 100)},
                {"continuous_obs": rng.standard_normal((6, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (6, 2)).astype(np.float32)},
                {"text": rng.integers(0, 256, 30)}]
    arrays = JaxPacker(JaxConfig(**shape)).pack_batch(examples)
    arrays.pop("lengths")
    return arrays


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax model, jax params, port config, converted state dict)."""
    shape = {"smoke": SMOKE, "odd": ODD}[name]
    jmodel = JaxModel(JaxConfig(**shape))
    params = jmodel.init({"params": jax.random.key(4)}, jax_batch(_arrays(shape)))["params"]
    cfg = ModelConfig(**shape)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jmodel, params, cfg, sd


@pytest.mark.parametrize("name,hd", [("smoke", 16), ("odd", 48)])
def test_train_step_matches_jax(name, hd):
    jmodel, params, cfg, sd = _pair(name)
    assert cfg.head_dim == hd and not attn.wide_heads(hd)
    assert ba.supported(cfg.context_len, hd)
    arrays = _arrays({"smoke": SMOKE, "odd": ODD}[name])

    def loss_fn(p):
        return jmodel.apply({"params": p}, jax_batch(arrays), deterministic=True,
                            compute_loss=True)[1]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    want = convert.jax_grads_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    model = convert.build_model(cfg, {k: v.clone() for k, v in sd.items()}, device="cpu")
    g = torch.Generator().manual_seed(0)  # train mode, dropout 0: deterministic
    _, loss = model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True, generator=g)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    got = dict(model.named_parameters())
    for pname, w in want.items():
        np.testing.assert_allclose(got[pname].grad.numpy(), w.numpy(), err_msg=pname,
                                   **GRAD_TOL)


def test_prefill_and_decode_steps_match_jax_at_hd_16():
    jmodel, params, cfg, sd = _pair("smoke")
    model = convert.build_model(cfg, sd, device="cpu")
    rng = np.random.default_rng(3)
    arrays = JaxPacker(JaxConfig(**SMOKE)).pack_batch(
        [{"text": rng.integers(0, 256, 50)}, {"text": rng.integers(0, 256, 11)}])
    lengths = arrays.pop("lengths")
    emb = np.array(jmodel.apply({"params": params}, jax_batch(arrays),
                                method=JaxModel.embed_batch))
    mask = arrays["input_mask"]
    want, vars_ = jmodel.apply({"params": params}, jnp.asarray(emb), jnp.asarray(mask),
                               method=JaxModel.prefill, mutable=["cache"])
    jcache = vars_["cache"]
    with torch.no_grad():
        got, caches = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], **LOGIT_TOL)
    pos = lengths.astype(np.int32)
    for _ in range(4):
        tok = rng.integers(0, 256, (2, 1)).astype(np.int32)
        e = np.array(jmodel.apply({"params": params}, jnp.asarray(tok),
                                  method=JaxModel.embed_tokens))
        want, vars_ = jmodel.apply({"params": params, "cache": jcache}, jnp.asarray(e),
                                   jnp.asarray(pos), method=JaxModel.decode_step,
                                   mutable=["cache"])
        jcache = vars_["cache"]
        with torch.no_grad():
            got = model.decode_step(torch.from_numpy(e), torch.from_numpy(pos), caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        pos = pos + 1


def test_wrappers_pad_an_odd_head_dim_to_the_plain_result():
    """hd 48 through every wrapper (zero-padded to 64, sm_scale from 48)
    against the plain versions at hd 48, fp32, with dropout."""
    B, H, S, hd = 2, 3, 90, 48
    rng = np.random.default_rng(48)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, S, hd)).astype(np.float32))
                   for _ in range(4))
    start = torch.tensor([0, 20], dtype=torch.int32)
    end = torch.tensor([S, S], dtype=torch.int32)
    seed = torch.tensor([11], dtype=torch.int32)
    ks = whk.dropout_keep_scale_reference(seed, B, H, S, 0.1)
    tol = dict(rtol=1e-5, atol=1e-5)

    out, _ = whk.whole_head_attention_fwd(q, k, v, start, end, seed, None, 0.1)
    torch.testing.assert_close(out, whk.whole_head_attention_reference(q, k, v, start, end,
                                                                        None, ks), **tol)
    o, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, 0.1)
    o_w, m_w, l_w = ba.blocked_fwd_reference(q, k, v, start, end, None, ks)
    for got, want in ((o, o_w), (m, m_w), (l, l_w)):
        torch.testing.assert_close(got, want, **tol)
    delta = ba.row_delta(do, o)
    bwd = (q, k, v, do, m, l, delta, start, end)
    want = ba.blocked_bwd_fused_reference(*bwd, None, ks)
    for got in (ba.blocked_attention_bwd_fused(*bwd, seed, None, 0.1),
                (ba.blocked_attention_dq(*bwd, seed, None, 0.1),
                 *ba.blocked_attention_dkv(*bwd, seed, None, 0.1))):
        for g, w in zip(got, want):
            assert g.shape == (B, H, S, hd)
            torch.testing.assert_close(g, w, **tol)
    L = m + torch.log(l.clamp_min(1e-30))
    at = (0, 0, start, end)
    acc, m_r, _ = rk.ring_partial_fwd(q, k, v, *at, seed, None, 0.1)
    torch.testing.assert_close(acc, rk.ring_partial_fwd_reference(q, k, v, *at, None, ks)[0],
                               **tol)
    torch.testing.assert_close(rk.ring_partial_dq(q, k, v, do, L, delta, *at, seed, None, 0.1),
                               rk.ring_partial_dq_reference(q, k, v, do, L, delta, *at, None, ks),
                               **tol)
    qd = q[:, :, -1]
    mask = torch.from_numpy(rng.random((B, S)) < 0.8)
    s2, e2 = whk.mask_bounds_from_key_mask(mask)
    torch.testing.assert_close(
        da.decode_cache_attention(qd, k, v, s2, e2, mask),
        da.decode_cache_attention_reference(qd, k, v, s2, e2, key_mask=mask), **tol)


def test_head_dims_the_kernels_take():
    bf16, fp32 = whk.head_dims(torch.bfloat16), whk.head_dims(torch.float32)
    assert whk.kernel_head_dim(16, bf16) == 16 and whk.kernel_head_dim(16, fp32) == 32
    assert whk.kernel_head_dim(48, bf16) == 64 and whk.kernel_head_dim(48, fp32) == 64
    assert whk.kernel_head_dim(100, da.KERNEL_HEAD_DIMS) == 128
    assert whk.kernel_head_dim(256, bf16) == 256  # above 128: no kernel, never padded
    for hd in (8, 16, 48, 80, 128):
        assert not attn.wide_heads(hd) and ba.supported(1024, hd) and ba.supported(3000, hd)
        assert rk.supported(300, hd)
        assert da.supported(2, 4, 100, hd)
    assert attn.wide_heads(256) and not ba.supported(1024, 256) and not rk.supported(128, 160)


# ------------------------- plain backwards at hd 16 in bf16 vs the TPU kernels
B16, H16, HD16, S16 = 2, 4, 16, 1024


@functools.lru_cache(maxsize=None)
def _bf16_inputs():
    """bf16-representable numpy q, k, v, do [B, S, H * 16], start, end: a
    left-padded row and a full one; do is 0 where no key is seen."""
    rng = np.random.default_rng(16)
    x = [torch.from_numpy(rng.standard_normal((B16, S16, H16 * HD16)).astype(np.float32))
         .bfloat16() for _ in range(4)]
    start = np.array([S16 // 5, 0], np.int32)
    end = np.full(B16, S16, np.int32)
    valid = np.arange(S16)[None, :] >= start[:, None]
    x[3] = x[3] * torch.from_numpy(valid)[..., None]
    return x, start, end


def _np32(t):
    return t.float().numpy()


@pytest.mark.parametrize("kernel", ["dq", "fused", "dkv"])
def test_plain_blocked_backward_matches_the_jax_kernel_at_hd_16_bf16(kernel):
    (q, k, v, do), start, end = _bf16_inputs()
    S = S16
    bf = [jnp.asarray(_np32(t), jnp.bfloat16) for t in (q, k, v, do)]
    rest = (jnp.asarray(start), jnp.asarray(end), jnp.zeros((1,), jnp.int32), H16,
            HD16 ** -0.5, 0.0)
    with jax.default_matmul_precision("highest"):
        o, m, l = jba._pallas_fwd(*bf[:3], *rest)
    m, l = (np.asarray(x).reshape(B16, H16, S) for x in (m, l))
    o = np.asarray(o.astype(jnp.float32))
    delta = (_np32(do) * o).reshape(B16, S, H16, HD16).sum(-1).transpose(0, 2, 1)
    stats = [jnp.asarray(x.reshape(B16, 1, H16, S)) for x in (m, l, delta)]
    jax_fn, port_fn = {"dq": (jba._pallas_dq, ba.blocked_dq_reference),
                       "fused": (jba._pallas_bwd_fused, ba.blocked_bwd_fused_reference),
                       "dkv": (jba._pallas_dkv, ba.blocked_dkv_reference)}[kernel]
    with jax.default_matmul_precision("highest"):
        want = jax_fn(*bf, *stats, *rest)
    got = port_fn(*(whk._heads4(t, H16) for t in (q, k, v, do)),
                  *(torch.from_numpy(np.ascontiguousarray(x)) for x in (m, l, delta)),
                  torch.from_numpy(start), torch.from_numpy(end))
    if kernel == "dq":
        want, got = [want], [got]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np32(g.transpose(1, 2).reshape(B16, S, -1)),
                                   np.asarray(w.astype(jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("pair", [(1, 1), (2, 0), (2, 1)])
def test_plain_ring_pair_backward_matches_the_jax_kernels_at_hd_16_bf16(pair):
    n, S_l = 4, S16 // 4
    i, j = pair
    (q, k, v, do), start, end = _bf16_inputs()
    rows, cols = slice(i * S_l, (i + 1) * S_l), slice(j * S_l, (j + 1) * S_l)
    qi, kj, vj, doi = q[:, rows], k[:, cols], v[:, cols], do[:, rows]
    rng = np.random.default_rng(7 * i + j)
    L = torch.from_numpy(rng.standard_normal((B16, H16, S_l)).astype(np.float32) + 3.0)
    delta = torch.from_numpy(rng.standard_normal((B16, H16, S_l)).astype(np.float32))
    offs = jnp.asarray([i * S_l, j * S_l], jnp.int32)
    rest = (offs, jnp.asarray(start), jnp.asarray(end), jnp.zeros((1,), jnp.int32), H16,
            HD16 ** -0.5, 0.0, n, n)
    stats = [jnp.asarray(x.numpy().reshape(B16, 1, H16, S_l)) for x in (L, delta)]
    bf = [jnp.asarray(_np32(t), jnp.bfloat16) for t in (qi, kj, vj, doi)]
    with jax.default_matmul_precision("highest"):
        dq_w = jrk._partial_dq(*bf, *stats, *rest)
        dk_w, dv_w = jrk._partial_dkv(*bf, *stats, *rest)
    port_in = (*(whk._heads4(t, H16) for t in (qi, kj, vj, doi)), L, delta, i * S_l, j * S_l,
               torch.from_numpy(start), torch.from_numpy(end))
    dq = rk.ring_partial_dq_reference(*port_in)
    dk, dv = rk.ring_partial_dkv_reference(*port_in)
    for got, want in ((dq, dq_w), (dk, dk_w), (dv, dv_w)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.transpose(1, 2).reshape(B16, S_l, -1).numpy(),
                                   np.asarray(want.astype(jnp.float32)), **BF16_TOL)


# ------------------------------------- the compiled widths, forward and backward
@pytest.mark.parametrize("dtype,hd,width", [
    (torch.bfloat16, 16, 16),   # native: the tensor-core tiles are compiled at hd 16
    (torch.float32, 16, 32),    # the CUDA-core kernels pad hd 16 to 32
    (torch.bfloat16, 48, 64),
    (torch.float32, 48, 64),
    (torch.bfloat16, 8, 16),
    (torch.float32, 128, 128),
])
def test_one_head_dim_rule_for_the_forward_and_the_backward(dtype, hd, width):
    """`head_dims(dtype)` is the one set of compiled widths: every wrapper,
    forward and backward, pads hd to `kernel_head_dim(hd, head_dims(dtype))`
    and the kernels' argument check takes exactly those widths."""
    assert whk.head_dims(torch.bfloat16) == (16, 32, 64, 128)
    assert whk.head_dims(torch.float32) == (32, 64, 128)
    assert whk.kernel_head_dim(hd, whk.head_dims(dtype)) == width
    B, S = 1, 8
    start = torch.zeros(B, dtype=torch.int32)
    end = torch.full((B,), S, dtype=torch.int32)
    for d in (hd, width):
        x = torch.zeros(B, 2, S, d, dtype=dtype)
        if d in whk.head_dims(dtype):
            whk._check_kernel_args(x, x, x, start, end)
        else:
            with pytest.raises(ValueError):
                whk._check_kernel_args(x, x, x, start, end)


def test_head_dims_above_128_are_refused():
    x = torch.zeros(1, 2, 8, 256, dtype=torch.bfloat16)
    bounds = torch.zeros(1, dtype=torch.int32)
    assert whk.kernel_head_dim(256, whk.head_dims(torch.bfloat16)) == 256
    assert not whk.supported(8, 256, torch.bfloat16)
    with pytest.raises(ValueError):
        whk._check_kernel_args(x, x, x, bounds, bounds + 8)
