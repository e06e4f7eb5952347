"""Pipeline parallelism over ranks, the schedules and the train CLI
(the ranks, width and meshes of tests/test_torch_pipeline.py):

* dropout 0.1: 1F1B trains as GPipe does (neko_tpu's
  test_1f1b_train_step_matches_gpipe: the same (microbatch, layer) masks),
  and two microbatches of one input draw different masks; the planted
  "every microbatch shares one mask" fails that, "clip norm from the
  stage's own leaves" and "mean of microbatch means" fail the check against
  one process, "embedding gradient only on stage 0" the replicas' check.
* the train CLI over 2 ranks with `--mesh_pipe_axis 2 --pipeline_schedule
  1f1b`: its checkpoint restores in one process to the parameters the
  stages gathered, bit for bit, and onto stage 1 to that stage's leaves.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as tr  # noqa: E402

from neko_tpu_torch.parallel import pipeline  # noqa: E402

from tests.test_torch_pipeline import WIDTH, _pipe_mesh  # noqa: E402


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
