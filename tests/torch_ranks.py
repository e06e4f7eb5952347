"""Shared by the tests that hold the port's training over gloo CPU ranks
(`tools/check_torch_parallel_ranks.py`) against neko_tpu's TrainContext on
the virtual CPU mesh of the same shape (test_torch_parallel.py,
test_torch_seq_ranks.py, test_torch_pipeline.py)."""

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from neko_tpu.config import ModelConfig as JaxConfig
from neko_tpu.data.batch import to_device_batch as jax_batch

from neko_tpu_torch import convert
from neko_tpu_torch.parallel import pipeline

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import check_torch_parallel_ranks as tool  # noqa: E402

STEPS = 3
LOSS_RTOL = 2e-4
PARAM_ATOL = 2e-5


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = str(ROOT) + os.pathsep + e.get("PYTHONPATH", "")
    e["OMP_NUM_THREADS"] = "1"
    return e


def midpoint_jax(monkeypatch):
    """neko_tpu's train-mode patch positions at the interval midpoint (the
    tool sets the port's so)."""
    from neko_tpu.models import embeddings as jax_embeddings

    def mid(key, shape, lo, hi, *a, **kw):
        return jnp.round((lo + hi - 1) / 2.0).astype(jnp.int32)

    shim = types.SimpleNamespace(random=types.SimpleNamespace(split=jax.random.split,
                                                              randint=mid))
    monkeypatch.setattr(jax_embeddings, "jax", shim)


def canonical(params, cfg):
    """neko_tpu's params (per-layer, or stacked on a 'pipe' mesh) -> the
    port's canonical state dict."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    if "h_stack" in tree["transformer"]:
        stages = convert.jax_stacked_params_to_stage_state_dicts(tree, cfg)
        return pipeline.canonical_state_dict(stages, cfg)
    return convert.jax_params_to_state_dict(tree, cfg)


_JAX = {}


def jax_run(run, width, monkeypatch):
    """neko_tpu's STEPS steps on the run's mesh from its own initial
    parameters: (canonical initial state dict, losses, final parameters)."""
    run = dict(tool.RUN_KEYS, **run)
    key = (width, *(run[k] for k in ("data", "model", "seq", "pipe", "schedule", "micro",
                                     "loss", "fsdp", "fused_adamw", "ema")))
    if key in _JAX:
        return _JAX[key]
    from neko_tpu.parallel import sharding as jshd
    from neko_tpu.parallel.mesh import create_mesh
    from neko_tpu.training.train_state import OptimizerConfig as JaxOpt
    from neko_tpu.training.train_state import TrainContext as JaxContext

    midpoint_jax(monkeypatch)
    cfg = tool.model_config(width)
    n = tool.ranks_of(run)
    mesh = create_mesh(data=run["data"], model=run["model"], seq=run["seq"], pipe=run["pipe"],
                       devices=jax.devices()[:n])
    jctx = JaxContext(JaxConfig(**dataclasses.asdict(cfg)),
                      JaxOpt(**tool.WIDTHS[width]["opt"], fused_adamw=run["fused_adamw"],
                             ema_decay=run["ema"], pipeline_microbatches=run["micro"],
                             pipeline_schedule=run["schedule"]),
                      mesh, seed=0, fsdp=run["fsdp"])
    jbatch = jshd.shard_batch(mesh, jax_batch(tool.batch_arrays(cfg, width, loss=run["loss"])))
    jstate = jctx.init_state(jbatch)
    sd0 = canonical(jstate.params, cfg)
    losses = []
    for _ in range(STEPS):
        jstate, loss = jctx.train_step(jstate, jbatch)
        losses.append(float(loss))
    _JAX[key] = (sd0, losses, canonical(jstate.params, cfg))
    return _JAX[key]


def run_tool(runs, tmp_path, sd0, width, timeout=300):
    """The tool's `runs` (dicts of its RUN_KEYS, one number of ranks) in one
    spawn of gloo CPU ranks from `sd0`: [(the run's JSON line, rank 0's
    gathered parameters)]."""
    state, out = tmp_path / "state.pt", tmp_path / "out.pt"
    torch.save(sd0, state)
    code = "\n".join([
        "import json, sys",
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})",
        "import check_torch_parallel_ranks as t",
        "if __name__ == '__main__':",
        f"    res = t.run_ranks({list(runs)!r}, device='cpu', width={width!r},"
        f" steps={STEPS}, state={str(state)!r}, out={str(out)!r}, timeout={timeout - 30})",
        "    tols = (2e-4, 1e-4, 1e-4, 1e-4)",
        "    print(json.dumps([t.summary(r, tols) for r in res]))",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = json.loads(r.stdout.strip().splitlines()[-1])
    paths = [out] if len(runs) == 1 else [Path(f"{out}.{i}") for i in range(len(runs))]
    return [(line, torch.load(p, weights_only=True)["params"]) for line, p in zip(lines, paths)]


def held_to_jax(res, gathered, jlosses, jparams):
    """Every rank's losses and the gathered parameters against neko_tpu's."""
    for losses in res["losses"]:
        np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert set(gathered) == set(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(gathered[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)


def cli_ranks(argv, tmp_path, timeout=300):
    """The train CLI over 2 gloo CPU ranks (`cli_ranks` of the tool):
    (per-rank readings, the canonical parameters the ranks end with)."""
    code = "\n".join([
        "import json, sys, torch",
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})",
        "import check_torch_parallel_ranks as t",
        "if __name__ == '__main__':",
        f"    out, sd = t.cli_ranks({list(argv)!r}, 2, cpu=True, params=True,"
        f" timeout={timeout - 60})",
        f"    torch.save(sd, {str(tmp_path / 'final.pt')!r})",
        "    print(json.dumps(out))",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return (json.loads(r.stdout.strip().splitlines()[-1]),
            torch.load(tmp_path / "final.pt", weights_only=True))
