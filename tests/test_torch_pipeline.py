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
* the masks do not depend on the stage count: two stages of two layers
  give what one stage of four gives, at one step seed.
* `chunked_masked_xent(return_sum_count=True)` against neko_tpu's; the
  stage-local <-> canonical round trip against `stack_pipeline_tree` /
  `unstack_pipeline_tree`; neko_tpu's refusals.

1F1B against GPipe with the planted faults, and the train CLI over the
ranks, are in tests/test_torch_pipeline_cli.py.
"""

import dataclasses

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
