"""Ring attention in the model and over processes, neko_tpu_torch against
neko_tpu on the CPU (the model and helpers of tests/test_torch_ring_attention.py):

* a model at context 512 under `create_mesh(seq=4)`: loss and every gradient
  against `jax.value_and_grad` of neko_tpu's NekoModel and against the port's
  own step without a mesh; three `TrainContext(mesh=...)` steps;
* the process-group schedule: 4 gloo processes (tools/check_torch_ring_ranks.py)
  against the one-device schedule.

Tolerances as tests/test_torch_train.py holds the model."""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.ops import ring_kernel as rk  # noqa: E402
from neko_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from neko_tpu_torch.training import train_state as ts  # noqa: E402

from tests.test_torch_ring_attention import (  # noqa: E402
    LONG, LOSS_TOL, MODEL_GRAD_TOL, RATE, ROOT, _long_arrays)


def test_model_under_a_seq_mesh_matches_jax_and_the_step_without_a_mesh(monkeypatch):
    arrays = _long_arrays()
    jmodel = JaxModel(JaxConfig(**LONG))
    params = jmodel.init({"params": jax.random.key(3)}, jax_batch(arrays))["params"]

    def loss_fn(p):
        return jmodel.apply({"params": p}, jax_batch(arrays), deterministic=True,
                            compute_loss=True)[1]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    cfg = ModelConfig(**LONG)
    want = convert.jax_grads_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)

    calls = []
    fwd = rk.ring_partial_fwd
    monkeypatch.setattr(rk, "ring_partial_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))

    def port(mesh):
        model = convert.build_model(cfg, {k: v.clone() for k, v in sd.items()}, device="cpu")
        g = torch.Generator().manual_seed(0)  # train mode, dropout 0: deterministic
        with mesh:
            _, loss = model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True,
                            generator=g)
        loss.backward()
        return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters()}

    loss, grads = port(pmesh.create_mesh(data=1, seq=4))
    assert len(calls) == cfg.layers * 10  # 4 (4 + 1) / 2 pairs a layer: future pairs skipped
    np.testing.assert_allclose(loss, float(want_loss), **LOSS_TOL)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name], w.numpy(), err_msg=name, **MODEL_GRAD_TOL)
    plain_loss, plain_grads = port(pmesh.create_mesh(data=1))
    assert len(calls) == cfg.layers * 10  # no ring off a seq axis
    np.testing.assert_allclose(loss, plain_loss, **LOSS_TOL)
    for name, w in plain_grads.items():
        np.testing.assert_allclose(grads[name], w, err_msg=name, **MODEL_GRAD_TOL)


def test_three_train_steps_under_a_seq_mesh_match_the_steps_without_one():
    cfg = ModelConfig(**dict(LONG, dropout=0.1))
    opt = ts.OptimizerConfig(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2,
                             training_steps=10, grad_norm_clip=0.5)
    batch = to_device_batch(_long_arrays(), "cpu")
    sd = convert.init_state_dict(cfg, 5)
    runs = []
    for mesh in (pmesh.create_mesh(data=1, seq=4), None):
        ctx = ts.TrainContext(cfg, opt, device="cpu", seed=2, mesh=mesh)
        state = ctx.init_state({k: v.clone() for k, v in sd.items()})
        losses = [ctx.train_step(state, batch)[1].item() for _ in range(3)]
        runs.append((losses, dict(state.model.named_parameters()), ctx.eval_step(state, batch)))
        assert pmesh.active_mesh() is None  # the step leaves no mesh active
    (ring, p_ring, e_ring), (plain, p_plain, e_plain) = runs
    assert len(set(ring)) == 3 and all(np.isfinite(ring))
    # one seed, one dropout mask through the ring and through the blocked /
    # whole-head dispatch: the runs agree to summation order
    np.testing.assert_allclose(ring, plain, **LOSS_TOL)
    np.testing.assert_allclose(e_ring.item(), e_plain.item(), **LOSS_TOL)
    moved = 0.0
    for name, p in p_ring.items():
        # (AdamW divides by sqrt(v): on gradients near 0 the two summation
        # orders' 1e-9 noise moves a weight by up to ~1e-6 a step)
        np.testing.assert_allclose(p.detach().numpy(), p_plain[name].detach().numpy(),
                                   err_msg=name, rtol=1e-4, atol=1e-5)
        moved = max(moved, (p.detach() - sd[name]).abs().max().item())
    assert moved > 1e-4


# ----------------------------------------------- the process-group schedule
def test_four_gloo_processes_agree_with_the_one_device_schedule():
    """tools/check_torch_ring_ranks.py spawns 4 processes on CPU tensors
    (its own limit 120 s); every rank's out, dq, dk, dv block within 1e-6 of
    the one-device schedule's (the same plain versions in the same order)."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "check_torch_ring_ranks.py"),
                        "--device", "cpu", "--ranks", "4", "--s_local", "128", "--rate",
                        str(RATE), "--atol", "1e-6", "--timeout", "120"],
                       cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ok"] and res["ranks"] == 4 and res["backend"] == "gloo"
    assert max(res["max_abs_err"].values()) <= 1e-6
