"""Ring attention at hd > 128 (ops/ring_kernel.py: the ring's schedule with
the plain pair steps `plain_partial_*` where no kernel is compiled) against
neko_tpu's XLA ring on the CPU, fp32, hd 256:

* `ring_attention_bsd` forward and `torch.autograd` gradients against
  neko_tpu's `sequence_parallel_attention` under its ('data', 'seq',
  'model') mesh on the virtual CPU devices and `jax.vjp`, over 2 and 4
  shards, on the rows that see a key (do is 0 on the others: there the
  JAX ring leaves an average, the port 0), dropout 0;
* dropout by an injected keep/scale matrix: the ring with the seed's Philox
  mask equals a jnp attention given the same matrix;
* a model at hd 256 under `create_mesh(seq=2)`: loss and every gradient
  against `jax.value_and_grad` of neko_tpu's NekoModel under its seq mesh
  (its XLA ring), no kernel wrapper called;
* 2 gloo processes (tools/check_torch_ring_ranks.py --hd 256) against the
  one-device schedule.

Tolerances: those of tests/test_torch_ring_attention.py (outputs atol 2e-5,
gradients atol 1e-4; the model as tests/test_torch_train.py holds it)."""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.ops.attention import sequence_parallel_attention  # noqa: E402
from neko_tpu.parallel.mesh import create_mesh as jax_mesh  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.ops import attention_kernel as whk  # noqa: E402
from neko_tpu_torch.ops import ring_kernel as rk  # noqa: E402
from neko_tpu_torch.parallel import mesh as pmesh  # noqa: E402

from tests.test_torch_ring_attention import (  # noqa: E402
    GRAD_TOL, LOSS_TOL, MODEL_GRAD_TOL, OUT_TOL, RATE, ROOT, SEED, _key_mask, _t)

H, HD = 2, 256
D = H * HD
KERNELS = (rk.ring_partial_fwd, rk.ring_partial_dq, rk.ring_partial_dkv)


def _inputs(n, S_l, B=2):
    """numpy q, k, v, do [B, n * S_l, D] fp32, global start, end int32 [B],
    valid [B, S]: a full row and a row left-padded from inside shard 1;
    do is 0 where no key is seen."""
    S = n * S_l
    rng = np.random.default_rng(n * 100 + S_l)
    q, k, v, do = (rng.standard_normal((B, S, D)).astype(np.float32) for _ in range(4))
    start = np.array([0, S_l + S_l // 3][:B], np.int32)
    end = np.full(B, S, np.int32)
    valid = np.arange(S)[None, :] >= start[:, None]
    return q, k, v, do * valid[..., None], start, end, valid


def _bhsd_np(x):
    B, S, _ = x.shape
    return x.reshape(B, S, H, HD).transpose(0, 2, 1, 3)


def _port_ring(n, S_l, rate=0.0, seed=None):
    """(out, dq, dk, dv) numpy [B, S, D] of the port's ring on the CPU, and
    the kernel wrappers' launch counts it moved (none: hd 256)."""
    q, k, v, do, start, end, _ = _inputs(n, S_l)
    before = [f.launches for f in KERNELS]
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    out = rk.ring_attention_bsd(*xs, _t(start), _t(end), seed, n_shards=n, heads=H,
                                dropout_rate=rate)
    grads = torch.autograd.grad(out, xs, _t(do))
    moved = [f.launches - b for f, b in zip(KERNELS, before)]
    return (out.detach().numpy(), *(g.numpy() for g in grads)), moved


@pytest.mark.parametrize("n", [2, 4])
def test_wide_ring_matches_jax_sequence_parallel_attention(n, monkeypatch):
    S_l = 64
    S = n * S_l
    q, k, v, do, start, end, valid = _inputs(n, S_l)
    km = jnp.asarray(_key_mask(S, start, end))
    with jax_mesh(data=1, seq=n, model=1, devices=jax.devices()[:n]):
        out, vjp = jax.vjp(jax.jit(lambda *xs: sequence_parallel_attention(*xs, km)),
                           *(jnp.asarray(_bhsd_np(x)) for x in (q, k, v)))
        want = [np.asarray(g).transpose(0, 2, 1, 3).reshape(2, S, D)
                for g in vjp(jnp.asarray(_bhsd_np(do)))]
    out = np.asarray(out).transpose(0, 2, 1, 3).reshape(2, S, D)

    pairs = []
    plain = rk.plain_partial_fwd
    monkeypatch.setattr(rk, "plain_partial_fwd",
                        lambda *a, **kw: pairs.append(1) or plain(*a, **kw))
    (got_out, *got), moved = _port_ring(n, S_l)
    assert moved == [0, 0, 0] and len(pairs) == n * (n + 1) // 2  # future pairs skipped
    np.testing.assert_allclose(got_out[valid], out[valid], **OUT_TOL)
    assert not got_out[~valid].any()  # rows that see no key: 0 in the port
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_wide_ring_dropout_equals_jnp_attention_with_the_same_mask():
    n, S_l = 4, 64
    S = n * S_l
    q, k, v, do, start, end, valid = _inputs(n, S_l)
    seed = torch.tensor([SEED], dtype=torch.int32)
    ks = whk.dropout_keep_scale_reference(seed, 2, H, S, RATE).numpy()
    allowed = jnp.asarray(np.tril(np.ones((S, S), bool))[None, None]
                          & _key_mask(S, start, end)[:, None, None, :])

    def ref(*xs):
        q4, k4, v4 = (x.reshape(2, S, H, HD).transpose(0, 2, 1, 3) for x in xs)
        logits = jnp.einsum("bhqd,bhkd->bhqk", q4, k4) * HD ** -0.5
        p = jax.nn.softmax(jnp.where(allowed, logits, -1e9), axis=-1) * jnp.asarray(ks)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v4).transpose(0, 2, 1, 3).reshape(2, S, D)

    out, vjp = jax.vjp(ref, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    (got_out, *got), moved = _port_ring(n, S_l, RATE, seed)
    assert moved == [0, 0, 0]
    np.testing.assert_allclose(got_out[valid], np.asarray(out)[valid], **OUT_TOL)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)


WIDE = dict(embed_dim=256, layers=2, heads=1, context_len=128, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64, discrete_tokens=64,
            dropout=0.0)


def _wide_arrays():
    rng = np.random.default_rng(12)
    examples = [{"text": rng.integers(0, 256, 120)},
                {"continuous_obs": rng.standard_normal((8, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (8, 2)).astype(np.float32)},
                {"text": rng.integers(0, 256, 40)}]
    arrays = JaxPacker(JaxConfig(**WIDE)).pack_batch(examples)
    arrays.pop("lengths")
    return arrays


def test_wide_model_under_a_seq_mesh_matches_jax_under_its_seq_mesh(monkeypatch):
    arrays = _wide_arrays()
    jmodel = JaxModel(JaxConfig(**WIDE))
    params = jax.jit(jmodel.init)({"params": jax.random.key(4)}, jax_batch(arrays))["params"]

    def loss_fn(p):
        return jmodel.apply({"params": p}, jax_batch(arrays), deterministic=True,
                            compute_loss=True)[1]

    with jax_mesh(data=1, seq=2, model=1, devices=jax.devices()[:2]):
        want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    cfg = ModelConfig(**WIDE)
    assert cfg.head_dim == 256
    want = convert.jax_grads_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)

    pairs = []
    plain = rk.plain_partial_dkv
    monkeypatch.setattr(rk, "plain_partial_dkv",
                        lambda *a, **kw: pairs.append(1) or plain(*a, **kw))
    before = [f.launches for f in KERNELS]
    model = convert.build_model(cfg, sd, device="cpu")
    with pmesh.create_mesh(data=1, seq=2):
        _, loss = model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True,
                        generator=torch.Generator().manual_seed(0))
    loss.backward()
    assert len(pairs) == cfg.layers * 3  # 2 (2 + 1) / 2 pairs a layer
    assert [f.launches for f in KERNELS] == before
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name,
                                   **MODEL_GRAD_TOL)


def test_two_gloo_processes_agree_with_the_one_device_schedule_at_hd_256():
    """tools/check_torch_ring_ranks.py at hd 256: each rank's out, dq, dk,
    dv block within 1e-6 of the one-device schedule's (the same plain pair
    steps in the same order), dropout on."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "check_torch_ring_ranks.py"),
                        "--backend", "gloo", "--ranks", "2", "--s_local", "64", "--heads", "1",
                        "--hd", "256", "--rate", str(RATE), "--atol", "1e-6", "--timeout", "120"],
                       cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["ranks"] == 2 and res["shape"][-1] == 256
    assert max(res["max_abs_err"].values()) <= 1e-6
