"""Pipeline parallelism over ranks (neko_tpu_torch/parallel/pipeline.py: a
'pipe' axis of `create_mesh` over a process group, GPipe and 1F1B) against
neko_tpu's pipelined TrainContext on the virtual CPU mesh of the same shape
(tests/test_pipeline.py's meshes).

The ranks are gloo processes on the CPU spawned by
`tools/check_torch_parallel_ranks.py` at its `small4` width (128d / 4
layers / 4 heads, k = 64, fp32; the root bench's row mix, 4 rows, 2
microbatches), so a stage holds two layers.  Every configuration starts
from neko_tpu's initial parameters (its stacked h_stack tree, converted
per stage) and takes three steps:

* GPipe and 1F1B (one spawn of the ranks a mesh) at pipe=2, (data=2,
  pipe=2), (pipe=2, model=2), (data=2, pipe=2, fsdp), each against
  neko_tpu's TrainContext with the same schedule: each rank's losses equal
  neko_tpu's within rtol 2e-4, the parameters the stages gather within
  atol 2e-5, and the tool's one-process run within its limits; each stage
  holds its two layers (and their moments) and a copy of the root leaves,
  which stay equal.
* dropout 0.1: 1F1B trains as GPipe does (neko_tpu's
  test_1f1b_train_step_matches_gpipe: the same (microbatch, layer) masks),
  and two microbatches of one input draw different masks; the planted
  "every microbatch shares one mask" fails that, "clip norm from the
  stage's own leaves" and "mean of microbatch means" fail the check against
  one process, "embedding gradient only on stage 0" the replicas' check.
* the masks do not depend on the stage count: two stages of two layers
  give what one stage of four gives, at one step seed.
* `chunked_masked_xent(return_sum_count=True)` against neko_tpu's; the
  stage-local <-> canonical round trip against `stack_pipeline_tree` /
  `unstack_pipeline_tree`; neko_tpu's refusals.
* the train CLI over 2 ranks with `--mesh_pipe_axis 2 --pipeline_schedule
  1f1b`: its checkpoint restores in one process to the parameters the
  stages gathered, bit for bit, and onto stage 1 to that stage's leaves.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch_ranks as tr  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.parallel import pipeline, sharding  # noqa: E402
from neko_tpu_torch.parallel.collectives import LOCAL, Axis  # noqa: E402
from neko_tpu_torch.parallel.mesh import PIPE_AXES, Mesh  # noqa: E402

WIDTH = "small4"
MESHES = {
    "pipe2": dict(pipe=2, micro=2),
    "data2_pipe2": dict(data=2, pipe=2, micro=2),
    "pipe2_model2": dict(pipe=2, model=2, micro=2),
    "data2_pipe2_fsdp": dict(data=2, pipe=2, micro=2, fsdp=True),
}
SCHEDULES = ("gpipe", "1f1b")
_RANKS = {}


def _ranks(name, tmp_path, sd0):
    """Both schedules on mesh `name` in one spawn of the ranks (once a
    module): {schedule: (the tool's JSON line, gathered parameters)}."""
    if name not in _RANKS:
        runs = [dict(MESHES[name], schedule=sch) for sch in SCHEDULES]
        _RANKS[name] = dict(zip(SCHEDULES, tr.run_tool(runs, tmp_path, sd0, WIDTH)))
    return _RANKS[name]


def _pipe_mesh(stage, data=1, model=1, d=0, m=0):
    axes = tuple(Axis(n, i) if n > 1 else LOCAL for n, i in ((data, d), (2, stage), (model, m)))
    return Mesh(PIPE_AXES, (data, 2, model), None, axes)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(MESHES))
def test_configuration_matches_jax_train_context(name, schedule, tmp_path, monkeypatch):
    run = dict(MESHES[name], schedule=schedule)
    sd0, jlosses, jparams = tr.jax_run(run, WIDTH, monkeypatch)
    res, gathered = _ranks(name, tmp_path, sd0)[schedule]
    assert res["ok"], res  # against the tool's own one-process run; replicas equal
    tr.held_to_jax(res, gathered, jlosses, jparams)
    cfg = tr.tool.model_config(WIDTH)
    data, model = run.get("data", 1), run.get("model", 1)
    for (d, m), (_, p), local in zip(res["coords"], res["seq_pipe"], res["local_shapes"]):
        mesh = _pipe_mesh(p, data, model, d, m)
        shapes = convert.stage_shapes(cfg, mesh)
        specs = sharding.layout(shapes, model, data, run.get("fsdp", False))
        assert {k: tuple(v) for k, v in local.items()} == {
            k: sharding.local_shape(s, specs[k], mesh) for k, s in shapes.items()}
        assert sum(k.startswith("transformer.h.") for k in local) == 2 * 12  # two layers
    # a stage rests on its layers and the root: less than one process
    assert max(res["resting_bytes"]) < res["one_process_resting_bytes"]


def test_1f1b_trains_as_gpipe_and_planted_faults_fail(tmp_path, monkeypatch):
    base = dict(pipe=2, micro=2)
    sd0, _, _ = tr.jax_run(base, WIDTH, monkeypatch)
    f1b = dict(base, schedule="1f1b")
    runs = [dict(base, dropout=0.1), dict(f1b, dropout=0.1),
            dict(f1b, dropout=0.1, fault="every microbatch shares one mask"),
            dict(f1b, fault="clip norm from the stage's own leaves"),
            dict(base, fault="embedding gradient only on stage 0"),
            dict(f1b, fault="mean of microbatch means")]
    (gp, gp_p), (ob, ob_p), shared, norm, embed, means = tr.run_tool(runs, tmp_path, sd0, WIDTH)
    # the same per-(microbatch, layer) masks: the same trajectory (neko_tpu's rtol)
    assert gp["ok"] and ob["ok"], (gp, ob)
    for a, b in zip(gp["losses"], ob["losses"]):
        np.testing.assert_allclose(a, b, rtol=2e-5)
    for k, v in gp_p.items():
        np.testing.assert_allclose(ob_p[k].numpy(), v.numpy(), atol=2e-5, rtol=0, err_msg=k)
    assert gp["micro_mask_share"] < 0.05 and ob["micro_mask_share"] < 0.05
    assert ob["peak_saved_inputs"] == [2, 0]  # 2 (S - 1 - i) + 1 at most, M = 2 here
    shared = shared[0]
    assert not shared["ok"] and shared["micro_mask_share"] == 1.0, shared
    for bad in (norm[0], means[0]):
        assert not bad["ok"] and max(bad["loss_err"], bad["param_err"], bad["norm_err"]) > 1e-3
    embed = embed[0]
    assert not embed["ok"] and embed["replica_err"] > 1e-4, embed


def test_masks_do_not_depend_on_the_stage_count():
    cfg = tr.tool.model_config(WIDTH, dropout=0.1)
    sd = convert.init_state_dict(cfg, 0)
    whole = convert.build_model(cfg, sd, device="cpu")
    stages = [convert.build_model(cfg, sd, device="cpu", mesh=_pipe_mesh(p)) for p in (0, 1)]
    assert all(len(s.transformer.h) == 2 for s in stages)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, cfg.embed_dim, generator=g)
    mask = torch.ones(2, 64, dtype=torch.bool)
    with torch.no_grad():
        for m in (0, 1):
            one = pipeline.stage_forward(whole, x, mask, m, 0, step_seed=7)
            two = pipeline.stage_forward(stages[1], pipeline.stage_forward(
                stages[0], x, mask, m, 0, step_seed=7), mask, m, 1, step_seed=7)
            assert torch.equal(one, two), m
        other = pipeline.stage_forward(whole, x, mask, 1, 0, step_seed=7)
        assert not torch.equal(pipeline.stage_forward(whole, x, mask, 0, 0, step_seed=7), other)


def test_chunked_xent_return_sum_count_matches_jax():
    from neko_tpu.ops.losses import chunked_masked_xent as jax_xent

    from neko_tpu_torch.ops.losses import chunked_masked_xent

    rng = np.random.default_rng(0)
    B, S, D, V = 3, 40, 16, 50
    h = rng.standard_normal((B, S, D), dtype=np.float32)
    w = rng.standard_normal((D, V), dtype=np.float32) * 0.3
    tok = rng.integers(0, 60, (B, S)).astype(np.int32)
    im = rng.random((B, S)) < 0.9
    tm = rng.random((B, S)) < 0.7
    want = jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(tok), jnp.asarray(im),
                    jnp.asarray(tm), valid_vocab=45, chunk_size=16, return_sum_count=True)
    got = chunked_masked_xent(torch.from_numpy(h), torch.from_numpy(w.T.copy()),
                              torch.from_numpy(tok), torch.from_numpy(im), torch.from_numpy(tm),
                              45, chunk_size=16, return_sum_count=True)
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-5)
    assert got[1].item() == float(want[1])


def test_stage_local_round_trip_matches_stack_pipeline_tree():
    from neko_tpu.parallel.pipeline import stack_pipeline_tree, unstack_pipeline_tree

    cfg = tr.tool.model_config(WIDTH)
    sd = convert.init_state_dict(cfg, 3)
    params = convert.state_dict_to_jax_params(sd, cfg)
    stacked = jax.tree_util.tree_map(np.asarray, stack_pipeline_tree(params, 2, cfg.layers))
    stages = convert.jax_stacked_params_to_stage_state_dicts(stacked, cfg)
    for p, stage in enumerate(stages):
        want = pipeline.stage_state_dict(sd, cfg.layers, 2, p)
        assert set(stage) == set(want)
        for k, v in want.items():
            assert torch.equal(stage[k], v), k
    back = convert.stage_state_dicts_to_jax_stacked(stages, cfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, v in jax.tree_util.tree_flatten_with_path(stacked)[0]:
        np.testing.assert_array_equal(flat[path], v)
    canon = pipeline.canonical_state_dict(stages, cfg)
    assert list(canon) == list(sd) and all(torch.equal(canon[k], sd[k]) for k in sd)
    unstacked = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, unstack_pipeline_tree(stacked)), cfg)
    assert all(torch.equal(unstacked[k], sd[k]) for k in sd)


def test_refusals_as_in_jax():
    from neko_tpu.config import ModelConfig as JaxConfig
    from neko_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from neko_tpu.training.train_state import OptimizerConfig as JaxOpt
    from neko_tpu.training.train_state import TrainContext as JaxContext

    from neko_tpu_torch.parallel.mesh import create_mesh
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg = tr.tool.model_config(WIDTH)
    jmesh = jax_create_mesh(data=1, pipe=2, devices=jax.devices()[:2])
    for bad in (dict(stochastic_depth=0.1), dict(layers=3)):
        with pytest.raises(AssertionError):
            TrainContext(cfg.replace(**bad), OptimizerConfig(), device="cpu", mesh=_pipe_mesh(0))
    with pytest.raises(AssertionError, match="divisible"):  # neko_tpu's, at construction
        JaxContext(JaxConfig(**dataclasses.asdict(cfg.replace(layers=3))), JaxOpt(), jmesh,
                   seed=0)
    for fn in (create_mesh, jax_create_mesh):  # 'seq' does not compose with 'pipe'
        with pytest.raises(AssertionError):
            fn(data=1, seq=2, pipe=2)
    with pytest.raises(AssertionError, match="microbatches"):  # B % (data * n_micro)
        pipeline.check(cfg, _pipe_mesh(0, data=2), 4, local_batch=6)
    with pytest.raises(ValueError):
        TrainContext(cfg, OptimizerConfig(pipeline_schedule="interleaved"), device="cpu",
                     mesh=_pipe_mesh(0))


CLI = ["--text_datasets", "synthetic", "--text_datasets_paths", "synthetic", "--text_prop",
       "0.5", "--control_datasets", "neko-synth-continuous-v0", "neko-synth-image-v0",
       "--embed_dim", "32", "--layers", "2", "--heads", "2", "-k", "64", "--batch_size", "4",
       "--training_steps", "4", "--log_eval_freq", "2", "--eval_episodes", "1",
       "--eval_text_num_examples", "1", "--mixed_precision", "no", "--learning_rate", "1e-3",
       "--warmup_steps", "2", "--ema_decay", "0.5", "--save_model", "--save_mode",
       "checkpoint"]


def test_train_cli_with_pipe_over_two_ranks_restores_in_one_process(tmp_path):
    from neko_tpu_torch.cli.build import build_context, resolve_checkpoint_and_args
    from neko_tpu_torch.training.train_state import TrainContext
    from neko_tpu_torch.utils.checkpoint import load_checkpoint

    ranks, final = tr.cli_ranks(CLI + ["--mesh_pipe_axis", "2", "--pipeline_schedule", "1f1b",
                                       "--pipeline_microbatches", "2", "--save_dir",
                                       str(tmp_path / "runs")], tmp_path)
    assert [x["steps"] for x in ranks] == [4, 4]
    assert all(x["mesh"] == {"data": 1, "pipe": 2, "model": 1} for x in ranks)
    exp = Path(ranks[0]["exp_dir"])
    logs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert len(logs) == 2 and any(k.startswith("evaluation/") for k in logs[-1])
    ckpt, args = resolve_checkpoint_and_args(str(exp), {"cpu": True, "device": "cpu"})
    assert args.mesh_pipe_axis == 1
    ctx, _ = build_context(args)
    state = load_checkpoint(ckpt, ctx)
    assert ctx.mesh is None and state.step == 4 and state.ema is not None
    got = dict(state.model.named_parameters())
    assert set(got) == set(final)
    for k, v in final.items():
        assert torch.equal(got[k].detach(), v), k
    # onto stage 1 of the mesh that wrote it: that stage's leaves, moments, EMA
    sctx = TrainContext(ctx.model_cfg, ctx.opt_cfg, device="cpu", seed=args.seed,
                        mesh=_pipe_mesh(1))
    sstate = load_checkpoint(ckpt, sctx)
    want = pipeline.stage_state_dict(final, ctx.model_cfg.layers, 2, 1)
    assert {n: list(p.shape) for n, p in sstate.model.named_parameters()} == ranks[1][
        "local_shapes"]
    for k, p in sstate.model.named_parameters():
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(sstate.ema[k], pipeline.stage_state_dict(
            state.ema, ctx.model_cfg.layers, 2, 1)[k]), k
    moments = sstate.optimizer.state_dict()["state"]
    canon = state.optimizer.state_dict()["state"]
    names = [n for n, _ in state.model.named_parameters()]
    local = [n for n, _ in sstate.model.named_parameters()]
    for i, n in enumerate(local):
        c = names.index(sctx.canonical_name(n))
        assert torch.equal(moments[i]["exp_avg"], canon[c]["exp_avg"]), n
