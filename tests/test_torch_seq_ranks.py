"""Sequence parallelism over ranks (a 'seq' axis of `create_mesh` over a
process group: each rank holds S / n columns of every activation and the
attention runs as the ring over the 'seq' group) against neko_tpu's
TrainContext on the virtual CPU mesh of the same shape.

The ranks are gloo processes on the CPU spawned by
`tools/check_torch_parallel_ranks.py` at its small width (128d / 2 layers /
4 heads, k = 64, fp32, dropout 0; the root bench's row mix, 4 rows), so a
rank holds 32 columns.  Every configuration starts from neko_tpu's initial
parameters, converted, and takes three steps:

* (seq=2), (data=2, seq=2), (seq=2, model=2), (data=2, seq=2, fsdp): each
  rank's losses equal neko_tpu's within rtol 2e-4, the parameters the ranks
  gather within atol 2e-5 (test_torch_parallel.py says why), and the tool's
  own one-process run under the one-device seq=2 mesh within its limits;
  every leaf is whole on every 'seq' rank (replicated there, as neko_tpu's
  param_pspec has no 'seq'), split over 'model' and 'data' as elsewhere.
* dropout 0.1: the ring over the ranks and every other mask equal the
  one-device seq=2 shards' at one seed (the ranks' attention seed is the
  ring path's data * 100,003 + model * 100,004, the same on every 'seq'
  peer, and each rank's residual, MLP and embedding masks are its columns
  of one draw), losses within float rounding; the planted "seq peers share
  a mask" (each rank draws the mask of its own columns' shape from the
  shared generator) fails that check.
* the chunked loss route: the planted "boundary target dropped" (the
  next-token shift taken within the rank's columns, so a block's last
  column loses its target) fails the check against one process and against
  neko_tpu; "gradients not summed over 'seq'" fails too.
* the train CLI over 2 ranks with `--multihost --mesh_seq_axis 2`: its
  checkpoint restores in one process to the parameters the ranks gathered,
  bit for bit.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks as tr  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.models.policy import seed_offset  # noqa: E402
from neko_tpu_torch.parallel import sharding  # noqa: E402
from neko_tpu_torch.parallel.collectives import LOCAL, Axis  # noqa: E402
from neko_tpu_torch.parallel.mesh import AXES, Mesh  # noqa: E402

WIDTH = "small"
CONFIGS = {
    "seq2": dict(seq=2),
    "data2_seq2": dict(data=2, seq=2),
    "seq2_model2": dict(seq=2, model=2),
    "data2_seq2_fsdp": dict(data=2, seq=2, fsdp=True),
}


def _mesh(data, seq, model, d=0, s=0, m=0):
    axes = tuple(Axis(n, i) if n > 1 else LOCAL for n, i in ((data, d), (seq, s), (model, m)))
    return Mesh(AXES, (data, seq, model), axes[1].group, axes)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configuration_matches_jax_train_context(name, tmp_path, monkeypatch):
    run = CONFIGS[name]
    sd0, jlosses, jparams = tr.jax_run(run, WIDTH, monkeypatch)
    [(res, gathered)] = tr.run_tool([run], tmp_path, sd0, WIDTH)
    assert res["ok"], res  # against the tool's own one-process run (one-device shards)
    assert len(res["losses"]) == tr.tool.ranks_of(dict(tr.tool.RUN_KEYS, **run))
    tr.held_to_jax(res, gathered, jlosses, jparams)
    # each rank: its 'data' / 'model' blocks, whole over 'seq'
    shapes = convert.model_shapes(tr.tool.model_config(WIDTH))
    data, model = run.get("data", 1), run.get("model", 1)
    specs = sharding.layout(shapes, model, data, run.get("fsdp", False))
    for (d, m), local in zip(res["coords"], res["local_shapes"]):
        mesh = _mesh(data, 2, model, d, 0, m)
        assert {k: tuple(v) for k, v in local.items()} == {
            k: sharding.local_shape(s, specs[k], mesh) for k, s in shapes.items()}
    assert sorted(s for s, _ in res["seq_pipe"]) == sorted([0, 1] * (data * model))


def test_dropout_masks_equal_the_one_device_shards_and_planted_faults_fail(tmp_path,
                                                                           monkeypatch):
    # the attention seed under a 'seq' axis: the ring path's, the 'seq'
    # coordinate left out
    assert seed_offset(_mesh(2, 2, 2, 1, 1, 1)) == 100_003 + 100_004
    assert seed_offset(_mesh(2, 2, 2, 0, 1, 0)) == 0
    assert seed_offset(_mesh(2, 1, 2, 1, 0, 1)) == 100_003 + 100_005  # off 'seq': every axis
    seq = dict(seq=2)
    sd0, _, _ = tr.jax_run(seq, WIDTH, monkeypatch)
    _, jlosses, jparams = tr.jax_run(dict(seq, loss="chunked"), WIDTH, monkeypatch)
    runs = [dict(seq, dropout=0.1), dict(seq, dropout=0.1, fault="seq peers share a mask"),
            dict(seq, loss="chunked"), dict(seq, loss="chunked", fault="boundary target dropped"),
            dict(seq, fault="gradients not summed over 'seq'")]
    (drop, _), (shared, _), (chunked, gathered), (boundary, gathered_b), (unsummed, _) = (
        tr.run_tool(runs, tmp_path, sd0, WIDTH))
    # dropout 0.1: held to the one-device seq=2 shards at one seed
    assert drop["ok"] and drop["loss_err"] < 1e-6 and drop["param_err"] < 1e-4, drop
    assert not shared["ok"] and shared["loss_err"] > 1e-3, shared
    # the chunked route matches neko_tpu's; the dropped boundary target does not
    assert chunked["ok"], chunked
    tr.held_to_jax(chunked, gathered, jlosses, jparams)
    assert not boundary["ok"] and boundary["loss_err"] > 2e-4, boundary
    with pytest.raises(AssertionError):
        tr.held_to_jax(boundary, gathered_b, jlosses, jparams)
    assert not unsummed["ok"] and unsummed["param_err"] > 1e-2, unsummed


CLI = ["--text_datasets", "synthetic", "--text_datasets_paths", "synthetic", "--text_prop",
       "0.5", "--control_datasets", "neko-synth-continuous-v0", "neko-synth-image-v0",
       "--embed_dim", "32", "--layers", "2", "--heads", "2", "-k", "64", "--batch_size", "4",
       "--training_steps", "4", "--log_eval_freq", "2", "--eval_episodes", "1",
       "--eval_text_num_examples", "1", "--mixed_precision", "no", "--learning_rate", "1e-3",
       "--warmup_steps", "2", "--dropout", "0.1", "--save_model", "--save_mode",
       "checkpoint"]


def test_train_cli_with_seq_over_two_ranks_restores_in_one_process(tmp_path):
    from neko_tpu_torch.cli.build import build_context, resolve_checkpoint_and_args
    from neko_tpu_torch.utils.checkpoint import load_checkpoint

    ranks, final = tr.cli_ranks(CLI + ["--mesh_seq_axis", "2", "--save_dir",
                                       str(tmp_path / "runs")], tmp_path)
    assert [x["steps"] for x in ranks] == [4, 4]
    assert all(x["mesh"] == {"data": 1, "seq": 2, "model": 1} for x in ranks)
    exp = Path(ranks[0]["exp_dir"])
    logs = [json.loads(line) for line in (exp / "metrics.jsonl").read_text().splitlines()]
    assert len(logs) == 2 and any(k.startswith("evaluation/") for k in logs[-1])
    assert all(np.isfinite(v) for log in logs for k, v in log.items()
               if k.startswith(("evaluation/", "training/train_loss")))
    ckpt, args = resolve_checkpoint_and_args(str(exp), {"cpu": True, "device": "cpu"})
    assert args.mesh_seq_axis == 1  # the restore runs in this one process
    ctx, _ = build_context(args)
    assert ctx.mesh is None
    state = load_checkpoint(ckpt, ctx)
    assert state.step == 4
    got = dict(state.model.named_parameters())
    assert set(got) == set(final)
    for k, v in final.items():
        assert torch.equal(got[k].detach(), v), k
