"""Training over processes (neko_tpu_torch/parallel/, TrainContext(mesh=,
fsdp=)) against neko_tpu's TrainContext on the virtual 8-device CPU mesh of
the same shape.

The ranks are gloo processes on the CPU, spawned by
`tools/check_torch_parallel_ranks.py` (the small width: 128d / 2 layers /
4 heads, k = 64, fp32, dropout 0; the root bench's row mix, 4 rows, whose
two data halves hold 73 and 64 loss targets).  Every configuration starts
from neko_tpu's initial parameters, converted, and takes three steps:

* (data=2), (data=2, fsdp, EMA 0.9), (model=2), (data=2, model=2, fsdp),
  (model=2, fused_adamw): each rank's three losses equal neko_tpu's within
  rtol 2e-4 (neko_tpu's own limit between meshes, tests/test_sharding.py);
  the parameters the ranks gather after the steps equal neko_tpu's within
  atol 2e-5 (Adam's update is near +-lr wherever |g| >> eps and turns on
  the rounding of g where g ~ 0: three steps at lr <= 1e-3 move such an
  element by ~1e-6 in a sound run) and the tool's one-process run within
  its own limits.  Under fsdp every rank's local shapes are neko_tpu's
  fsdp_param_pspec blocks (tests/test_torch_sharding.py holds the table)
  and its parameters, moments and EMA rest at most on half the tree plus
  the leaves under FSDP_MIN_SIZE.
* the planted "mean of local means" (each rank's mean loss, averaged over
  'data', as DistributedDataParallel averages) fails the check against
  neko_tpu on this batch: it weights the two halves' gradients wrongly, and
  the update of the tree is off by ~0.1 relative.
* the per-rank sampling streams: the port's Trainer at data coordinate d
  of 2 (on a mesh that also has a 'model' coordinate) packs the arrays
  neko_tpu's Trainer packs with `process_info` (d, 2), and both globalize
  to the same global rows.
* dropout 0.1 under model = 2: the model peers' own gradients of every
  replicated leaf are bit-identical (they draw the same masks), and so are
  the leaves after the steps; the planted "model peers draw different
  dropout masks" makes the gradients differ.
* the train CLI over 2 ranks with `--multihost --fsdp` and with
  `--mesh_model_axis 2`: its checkpoint restores in one process to the
  parameters the ranks gathered, bit for bit, and onto a rank of the
  mesh that wrote it to that rank's blocks.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch_ranks as tr  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.parallel import sharding  # noqa: E402
from neko_tpu_torch.parallel.collectives import LOCAL, Axis  # noqa: E402
from neko_tpu_torch.parallel.mesh import AXES, Mesh  # noqa: E402

tool = tr.tool
CONFIGS = {
    "data2": dict(data=2),
    "data2_fsdp_ema": dict(data=2, fsdp=True, ema=0.9),
    "model2": dict(model=2),
    "data2_model2_fsdp": dict(data=2, model=2, fsdp=True),
    "model2_fused": dict(model=2, fused_adamw=True),
}


def _jax_run(run, monkeypatch):
    """neko_tpu's three steps on the (data, model) mesh from its own initial
    parameters: (canonical initial state dict, losses, final parameters)."""
    return tr.jax_run(run, "small", monkeypatch)


def _tool(run, tmp_path, sd0):
    """The tool on gloo CPU ranks from `sd0`: (its JSON line, rank 0's
    gathered parameters)."""
    return tr.run_tool([run], tmp_path, sd0, "small")[0]


def _fake_mesh(data, model, d=0, m=0):
    axes = (Axis(data, d) if data > 1 else LOCAL, LOCAL, Axis(model, m) if model > 1 else LOCAL)
    return Mesh(AXES, (data, 1, model), None, axes)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_matches_jax_train_context(name, tmp_path, monkeypatch):
    run = CONFIGS[name]
    sd0, jlosses, jparams = _jax_run(run, monkeypatch)
    res, gathered = _tool(run, tmp_path, sd0)
    n = run.get("data", 1) * run.get("model", 1)
    assert res["ok"], res  # against the tool's own one-process run
    assert len(res["losses"]) == n
    tr.held_to_jax(res, gathered, jlosses, jparams)
    cfg = tool.model_config("small")
    shapes = convert.model_shapes(cfg)
    specs = sharding.layout(shapes, run.get("model", 1), run.get("data", 1),
                            run.get("fsdp", False))
    for (d, m), local in zip(res["coords"], res["local_shapes"]):
        mesh = _fake_mesh(run.get("data", 1), run.get("model", 1), d, m)
        assert {k: tuple(v) for k, v in local.items()} == {
            k: sharding.local_shape(s, specs[k], mesh) for k, s in shapes.items()}
    if run.get("fsdp"):
        small = sum(s.numel() for s in shapes.values() if s.numel() < sharding.FSDP_MIN_SIZE)
        factor = 2 + (run.get("ema", 0.0) > 0)  # moments, and the EMA
        for rest in res["resting_bytes"]:
            assert rest <= (res["one_process_resting_bytes"] / 2
                            + 4 * (1 + factor) * small), (rest, res["one_process_resting_bytes"])
        assert any(s.data_dim is not None for s in specs.values())


def test_mean_of_local_means_fails_the_check(tmp_path, monkeypatch):
    run = dict(data=2, fault="mean of local means")
    sd0, jlosses, jparams = _jax_run(dict(data=2), monkeypatch)
    res, gathered = _tool(run, tmp_path, sd0)
    assert not res["ok"] and res["param_err"] > 1e-2, res
    with pytest.raises(AssertionError):
        tr.held_to_jax(res, gathered, jlosses, jparams)


@pytest.mark.parametrize("d", [0, 1])
def test_per_rank_streams_match_jax_trainer(d, tmp_path, monkeypatch):
    from neko_tpu.cli.build import build_context as jax_build_context
    from neko_tpu.parallel import multihost as jmh
    from neko_tpu.training.arguments import TrainingArgs as JaxArgs
    from neko_tpu.training.trainer import Trainer as JaxTrainer

    from neko_tpu_torch.cli.build import build_tasks, derive_max_patches, model_config_from_args
    from neko_tpu_torch.cli.build import optimizer_config_from_args
    from neko_tpu_torch.training.arguments import TrainingArgs
    from neko_tpu_torch.training.train_state import TrainContext
    from neko_tpu_torch.training.trainer import Trainer

    kw = dict(cpu=True, control_datasets=["neko-synth-continuous-v0", "neko-synth-image-v0"],
              text_datasets=["synthetic"], text_datasets_paths=["synthetic"], text_prop=0.375,
              embed_dim=32, layers=1, heads=2, batch_size=8, sequence_length=64,
              training_steps=4, log_eval_freq=2, mixed_precision="no", dropout=0.0,
              save_dir=str(tmp_path), log_jsonl=False, seed=0, eval_episodes=0,
              eval_text_num_examples=0)
    # neko_tpu's process d of 2: its trainer and, through jax.process_index,
    # its tasks' seeds
    monkeypatch.setattr(jmh, "process_info", lambda: (d, 2))
    monkeypatch.setattr(jax, "process_index", lambda *a: d)
    jargs = JaxArgs(**kw)
    jtr = JaxTrainer(*jax_build_context(jargs), "jax", jargs)
    assert jtr.local_batch_size == 4

    args = TrainingArgs(**kw)
    tasks = build_tasks(args, d)
    cfg = model_config_from_args(args, derive_max_patches(args, tasks))
    mesh = _fake_mesh(2, 2, d, 1)  # this rank's 'model' coordinate plays no part
    tr = Trainer(TrainContext(cfg, optimizer_config_from_args(args), device="cpu", mesh=mesh),
                 tasks, "port", args)
    assert (tr.data_index, tr.data_count, tr.local_batch_size) == (d, 2, 4)
    for _ in range(3):
        a, b = tr.sample_arrays(), jtr.sample_arrays()
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # neko_tpu's re-basing to global rows, the port's rows at data coordinate d
        ga, gb = jmh.globalize_arrays(a, d, 2), jmh.globalize_arrays(b, d, 2)
        for k in ga:
            np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)
        rows = ga["patch_batch"]  # this rank's global rows, the unused entries at 8
        used = rows < 8
        assert used.any() and ((rows[used] >= 4 * d) & (rows[used] < 4 * d + 4)).all()


def test_dropout_keeps_model_peers_in_step(tmp_path):
    sd0 = convert.init_state_dict(tool.model_config("small"), 0)
    sound, _ = _tool(dict(model=2, dropout=0.1), tmp_path, sd0)
    # the peers' own gradients of every replicated leaf are equal, bit for
    # bit, before the sync averages them; so are the leaves after the steps
    assert sound["ok"] and sound["peer_grad_err"] == 0.0 and sound["replica_err"] == 0.0, sound
    assert sound["loss_err"] is None  # dropout: no loss compared with one process
    fault, _ = _tool(dict(model=2, dropout=0.1,
                          fault="model peers draw different dropout masks"), tmp_path, sd0)
    assert not fault["ok"] and fault["peer_grad_err"] > 1e-3, fault


CLI = ["--text_datasets", "synthetic", "--text_datasets_paths", "synthetic", "--text_prop",
       "0.5", "--control_datasets", "neko-synth-continuous-v0", "neko-synth-image-v0",
       "--embed_dim", "32", "--layers", "1", "--heads", "2", "-k", "64", "--batch_size", "4",
       "--training_steps", "4", "--log_eval_freq", "2", "--eval_episodes", "1",
       "--eval_text_num_examples", "1", "--mixed_precision", "no", "--learning_rate", "1e-3",
       "--warmup_steps", "2", "--ema_decay", "0.5", "--save_model", "--save_mode",
       "checkpoint"]


@pytest.mark.parametrize("flags", [["--fsdp"], ["--mesh_model_axis", "2"]])
def test_train_cli_over_two_ranks_restores_in_one_process(flags, tmp_path):
    from neko_tpu_torch.cli.build import build_context, resolve_checkpoint_and_args
    from neko_tpu_torch.training.train_state import TrainContext
    from neko_tpu_torch.utils.checkpoint import load_checkpoint

    runs = tmp_path / "runs"
    ranks, final = tr.cli_ranks(CLI + flags + ["--save_dir", str(runs)], tmp_path)
    assert [x["steps"] for x in ranks] == [4, 4]
    exp = Path(ranks[0]["exp_dir"])
    assert ranks[1]["exp_dir"] == str(exp)
    names = {p.name for p in exp.iterdir()}
    assert {"checkpoint_2", "checkpoint_4", "host_state_4_p0.pkl", "host_state_4_p1.pkl",
            "metrics.jsonl", "args.json"} <= names, names
    logs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert len(logs) == 2 and all(np.isfinite(v) for log in logs for k, v in log.items()
                                  if k.startswith("evaluation/"))
    assert any(k.startswith("evaluation/") for k in logs[-1])
    mesh = ranks[0]["mesh"]
    assert mesh["data"] * mesh["model"] == 2 and mesh["model"] == (2 if "--mesh_model_axis"
                                                                   in flags else 1)

    # one process: the canonical checkpoint, the parameters the ranks gathered
    ckpt, args = resolve_checkpoint_and_args(str(exp), {"cpu": True, "device": "cpu"})
    ctx, _ = build_context(args)
    assert ctx.mesh is None
    state = load_checkpoint(ckpt, ctx)
    assert state.step == 4 and state.ema is not None
    got = dict(state.model.named_parameters())
    assert set(got) == set(final)
    for k, v in final.items():
        assert torch.equal(got[k].detach(), v), k
    # onto rank 1 of the mesh that wrote it: that rank's blocks
    fake = _fake_mesh(mesh["data"], mesh["model"], 1 // mesh["model"], 1 % mesh["model"])
    rctx = TrainContext(ctx.model_cfg, ctx.opt_cfg, device="cpu", seed=args.seed,
                        fsdp="--fsdp" in flags, mesh=fake)
    rstate = load_checkpoint(ckpt, rctx)
    for k, p in rstate.model.named_parameters():
        assert list(p.shape) == ranks[1]["local_shapes"][k], k
        assert torch.equal(p.detach(), rctx.shard(k, final[k])), k
        assert torch.equal(rstate.ema[k], rctx.shard(k, state.ema[k])), k
    assert any(list(p.shape) != list(final[k].shape)
               for k, p in rstate.model.named_parameters())
