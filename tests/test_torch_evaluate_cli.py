"""The evaluation entry point of neko_tpu_torch (`python -m
neko_tpu_torch.cli.evaluate`) and the restore recipe it shares with
serving, against neko_tpu's on the CPU at a tiny width (32d, 1 layer, 2
heads, k = 64, fp32, 32x32 images; byte tokenizer):

* on the same weights (neko_tpu's initial state, written as its Orbax
  checkpoint and, converted, as the port's) and the same args.json, the
  port's `cli.evaluate.run` gives neko_tpu's `cli.evaluate.run` dict: the
  same `evaluation/<task>/<metric>` keys over the Text, Dict-observation
  and Dict-action envs, text, caption and VQA; control metrics within 1e-5,
  losses within 1e-4 relative; lockstep, and serial with `--render` and
  overrides of the saved args; stochastic mode repeats itself;
* a checkpoint written by the port's train CLI with those tasks evaluates;
* the task-less (serving) restore sizes its patch pool from the
  checkpoint's image embedder, as neko_tpu's `serving_max_patches`;
* `--use_ema` evaluates the EMA shadow of a run trained with
  `--ema_decay` (another text loss than its weights', the loss of the
  shadow loaded as weights), and raises neko_tpu's message on a checkpoint
  without one;
* `--serve_weight_dtype fp8` and `--kv_cache_dtype int8` evaluate as
  neko_tpu's with them; `--mesh_model_axis 2` outside torchrun's
  environment names itself; without `--cpu` the CLI needs a CUDA device
  (SystemExit here).
"""

import argparse
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("PIL")

import jax  # noqa: E402

from neko_tpu.cli import evaluate as jax_evaluate  # noqa: E402
from neko_tpu.cli.build import build_context as jax_build_context  # noqa: E402
from neko_tpu.training.arguments import TrainingArgs as JaxArgs  # noqa: E402
from neko_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from neko_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.cli import evaluate as cli_evaluate  # noqa: E402
from neko_tpu_torch.cli import train as cli_train  # noqa: E402
from neko_tpu_torch.cli.build import (  # noqa: E402
    build_context, load_state_for, resolve_checkpoint_and_args)
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.training.arguments import TrainingArgs  # noqa: E402
from neko_tpu_torch.utils.checkpoint import save_args  # noqa: E402

from tests.test_torch_caption_vqa import IMG, make_datasets, vqa_kwargs  # noqa: E402

CODEC_ENVS = ["neko-synth-text-v0", "neko-synth-dict-v0", "neko-synth-dictact-v0"]
CONTROL_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are tiny, and in a
    parallel test run the thread pools of the workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_args(cls, cap_dir, vqa_dir, **kw):
    v = vqa_kwargs(vqa_dir)
    d = dict(
        cpu=True, control_datasets=CODEC_ENVS, text_datasets=["synthetic"],
        text_datasets_paths=["synthetic"], caption_dataset=cap_dir, test_data_prop=0.4,
        vqa_dataset=vqa_dir, vqa_train_data=v["train_data"], vqa_test_data=v["test_data"],
        train_img_name_prefix=v["train_img_name_prefix"],
        train_img_file_name_len=v["train_img_file_name_len"],
        test_img_name_prefix=v["test_img_name_prefix"],
        test_img_file_name_len=v["test_img_file_name_len"],
        caption_image_size=IMG, vqa_image_size=IMG, text_prop=0.25, caption_prop=0.25,
        vqa_prop=0.125, embed_dim=32, layers=1, heads=2, batch_size=8, sequence_length=64,
        mixed_precision="no", dropout=0.0, eval_episodes=2, eval_text_num_examples=2,
        eval_caption_num_examples=2, eval_vqa_num_examples=2, training_steps=2,
        log_eval_freq=2, warmup_steps=2, learning_rate=1e-3, log_jsonl=False, seed=0)
    d.update(kw)
    return cls(**d)


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    """neko_tpu's initial state as its checkpoint and, converted, as the
    port's: (jax experiment dir, port experiment dir)."""
    base = tmp_path_factory.mktemp("eval")
    cap_dir, vqa_dir = make_datasets(base)
    jargs = make_args(JaxArgs, cap_dir, vqa_dir, save_dir=str(base / "jax"))
    jtr = JaxTrainer(*jax_build_context(jargs), "exp", jargs)
    jtr.init_state()
    jax_save_checkpoint(jtr.exp_dir, jtr.state, 1, jargs)
    args = make_args(TrainingArgs, cap_dir, vqa_dir, save_dir=str(base / "port"))
    exp = os.path.join(args.save_dir, "exp")
    cfg = ModelConfig.from_dict(
        {f: getattr(jtr.ctx.model_cfg, f) for f in ModelConfig.__dataclass_fields__})
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), cfg)
    convert.save_model_dir(os.path.join(exp, "checkpoint_1"), cfg, sd)
    save_args(exp, args)
    return jtr.exp_dir, exp


def _compare(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = CONTROL_TOL if k.split("/")[1] in CODEC_ENVS else dict(rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)
        assert np.isfinite(got[k]), k


# --render: serial episodes over control and text only; with overrides of
# the saved args (one env, one episode, two text examples)
RENDER = dict(render=True, control_datasets=["neko-synth-dict-v0"], eval_episodes=1,
              eval_text_num_examples=2)


@pytest.mark.parametrize("mode", ["lockstep", "render"])
def test_evaluate_cli_matches_jax_on_the_same_weights(same_weights, mode):
    jexp, exp = same_weights
    flags = RENDER if mode == "render" else dict(control_datasets=None)
    want = jax_evaluate.run(argparse.Namespace(model_path=jexp, cpu=True, **flags))
    argv = ["--model_path", exp, "--cpu"]
    if mode == "render":
        argv += ["--render", "--control_datasets", "neko-synth-dict-v0", "--eval_episodes",
                 "1", "--eval_text_num_examples", "2"]
    got = cli_evaluate.main(argv)
    envs = CODEC_ENVS if mode == "lockstep" else ["neko-synth-dict-v0"]
    keys = {f"evaluation/{n}/{m}" for n in envs for m in ("mean_return", "mean_episode_len")}
    kinds = ("text", "caption", "VQA") if mode == "lockstep" else ("text",)
    keys |= {f"evaluation/{t}/{m}" for t in kinds for m in ("loss", "perplexity")}
    assert set(want) == keys  # neko_tpu's rendered run evaluates control and text only
    _compare(got, want)


def test_evaluate_cli_overrides_and_stochastic_mode(same_weights):
    """The flags override args.json (without --render the one env's single
    episode runs serially too, as the rendered run does); stochastic mode
    with the sampling knobs is seeded, so a rerun repeats it."""
    _, exp = same_weights
    base = ["--model_path", exp, "--cpu", "--control_datasets", "neko-synth-dict-v0",
            "--eval_episodes", "1", "--eval_text_num_examples", "2"]
    got = cli_evaluate.main(base)
    rendered = cli_evaluate.main(base + ["--render"])
    assert set(rendered) < set(got) and not any("dictact" in k for k in got)
    assert {k: got[k] for k in rendered} == rendered
    argv = base + ["--eval_mode", "stochastic", "--temperature", "0.7", "--sample_top_k", "5",
                   "--sample_top_p", "0.9"]
    a, b = cli_evaluate.main(argv), cli_evaluate.main(argv)
    assert a == b and set(a) == set(got) and all(np.isfinite(v) for v in a.values())


def test_port_trained_checkpoint_evaluates(tmp_path, capsys):
    """`python -m neko_tpu_torch.cli.train --cpu` with caption, VQA, text and
    the Text / Dict envs, then the evaluation CLI on its experiment dir
    (which resolves to the latest checkpoint)."""
    cap_dir, vqa_dir = make_datasets(tmp_path)
    args = make_args(TrainingArgs, cap_dir, vqa_dir, save_dir=str(tmp_path / "runs"),
                     save_model=True, save_mode="checkpoint", eval_episodes=1,
                     eval_text_num_examples=1, eval_caption_num_examples=1,
                     eval_vqa_num_examples=1)
    trainer = cli_train.run(args, exp_name="exp")
    assert trainer.caption_tasks and trainer.vqa_tasks and trainer.patch_budget > 0
    capsys.readouterr()
    logs = cli_evaluate.main(["--model_path", trainer.exp_dir, "--cpu"])
    out = capsys.readouterr().out
    assert len(logs) == 2 * len(CODEC_ENVS) + 6 and all(np.isfinite(v) for v in logs.values())
    for k, v in logs.items():
        assert f"{k}: {v}" in out
    # the experiment dir resolves to its latest checkpoint
    assert resolve_checkpoint_and_args(trainer.exp_dir)[0] == os.path.join(
        trainer.exp_dir, "checkpoint_2")


def test_serving_restore_sizes_the_pool_from_the_checkpoint(same_weights):
    _, exp = same_weights
    ckpt, args = resolve_checkpoint_and_args(exp, {"max_patches": None})
    assert ckpt.endswith("checkpoint_1") and args.caption_dataset
    ctx, tasks = build_context(args, tasks=[], ckpt_path=ckpt)
    assert tasks == [] and ctx.model_cfg.max_patches == (256 // args.patch_size) ** 2
    model, packer = load_state_for(ctx, ckpt)
    assert model.image_embedding is not None and packer.P == ctx.model_cfg.max_patches
    saved = torch.load(os.path.join(ckpt, "model.pt"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], rtol=0, atol=0)
    # a restore that derives no image embedder for an image-trained checkpoint
    args.max_patches = 0
    ctx0, _ = build_context(args, tasks=[], ckpt_path=ckpt)
    with pytest.raises(ValueError, match="image embedder"):
        load_state_for(ctx0, ckpt)


@pytest.mark.parametrize("flag", [["--mesh_model_axis", "2"], ["--serve_weight_dtype", "fp8"],
                                  ["--kv_cache_dtype", "int8"]])
def test_refusals_name_themselves(same_weights, flag):
    """None of the three is refused any more: `--mesh_model_axis 2` outside
    torchrun's environment names itself (tests/test_torch_tp_serving.py runs
    it over ranks); fp8 weights and the int8 cache evaluate as neko_tpu's
    evaluation does with them (the serial run's tasks)."""
    jexp, exp = same_weights
    if flag[0] == "--mesh_model_axis":
        with pytest.raises(ValueError, match=flag[0]):
            cli_evaluate.main(["--model_path", exp, "--cpu"] + flag)
        return
    want = jax_evaluate.run(argparse.Namespace(model_path=jexp, cpu=True,
                                               **{flag[0][2:]: flag[1]}, **RENDER))
    got = cli_evaluate.main(["--model_path", exp, "--cpu", "--render", "--control_datasets",
                             "neko-synth-dict-v0", "--eval_episodes", "1",
                             "--eval_text_num_examples", "2"] + flag)
    _compare(got, want)


def test_use_ema_evaluates_the_shadow(tmp_path, same_weights):
    import shutil

    from neko_tpu_torch.utils.checkpoint import EMA

    trainer = cli_train.main([
        "--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
        "--text_prop", "1.0", "--embed_dim", "32", "--layers", "1", "--heads", "2", "-k", "64",
        "--batch_size", "4", "--training_steps", "2", "--log_eval_freq", "2",
        "--eval_text_num_examples", "0", "--mixed_precision", "no", "--learning_rate", "1e-2",
        "--ema_decay", "0.5", "--save_model", "--save_mode", "checkpoint",
        "--save_dir", str(tmp_path / "runs")])
    ckpt = os.path.join(trainer.exp_dir, "checkpoint_2")
    flags = ["--model_path", ckpt, "--cpu", "--eval_text_num_examples", "3"]
    plain = cli_evaluate.main(flags)["evaluation/text/loss"]
    ema = cli_evaluate.main(flags + ["--use_ema"])["evaluation/text/loss"]
    assert np.isfinite(ema) and ema != plain
    # the shadow as the weights of a copy of the checkpoint evaluates alike
    copy = str(tmp_path / "runs" / "copy" / "checkpoint_2")
    shutil.copytree(ckpt, copy)
    shutil.copy(os.path.join(trainer.exp_dir, "args.json"), os.path.dirname(copy))
    shutil.copy(os.path.join(copy, EMA), os.path.join(copy, "model.pt"))
    flags[1] = copy
    assert cli_evaluate.main(flags)["evaluation/text/loss"] == ema
    _, exp = same_weights
    with pytest.raises(ValueError, match="checkpoint has no EMA shadow"):
        cli_evaluate.main(["--model_path", exp, "--cpu", "--use_ema"])


def test_default_device_is_the_card(same_weights):
    _, exp = same_weights
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the CLI would run on it")
    with pytest.raises(SystemExit):
        cli_evaluate.main(["--model_path", exp])
