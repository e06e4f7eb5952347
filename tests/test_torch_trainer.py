"""The training entry point of neko_tpu_torch (Trainer, cli/build.py,
cli/train.py, checkpoints, exact resume) against neko_tpu's on the CPU at a
tiny width (32d, 1 layer, 2 heads, k = 64, batch 8, fp32; byte tokenizer):

* the Trainer's packed arrays (its patch and target budgets, every array)
  equal neko_tpu's Trainer's bit for bit over 6 steps of a text + four
  control envs mixture, and so does the host snapshot after them;
* four Trainer steps from neko_tpu's initial weights (converted): each
  loss within `test_torch_train.LOSS_TOL` of neko_tpu's (no image env: the
  JAX train mode samples patch positions from its own stream);
* exact resume, modelled on tests/test_exact_resume.py (dropout 0.1): a
  run resumed at step 2 replays steps 3-4 bit for bit in losses and in the
  packed stream; the emergency checkpoint resumes exactly; in-loop
  evaluation does not perturb the training stream;
* the three cases exact resume cannot cover: `--save_model` with several
  prefetch workers raises, a checkpoint whose sidecars were written for
  another process count raises, a checkpoint without a sidecar resumes
  approximately with the JAX package's message;
* evaluation leaves the training parameters fp32 and unchanged (bf16
  activations: it runs from its own bf16 copy);
* the package bench's end_to_end keys, the CLI's refusals;
* the CLI with every flag this port added to the train path on at once
  (the committed HDF5 fixtures in both name forms, fp16 as bf16,
  stochastic depth, remat, GEGLU, EMA, gradient accumulation k = 2,
  `--profile_dir`): a stop in the middle of an accumulation window resumes
  with the losses, the EMA and the weights of the uninterrupted run bit
  for bit; `--profile_dir` traces exactly `profile_steps` steps;
* with caption and VQA rows (32x32 JPEG data, 4 patches an image) in the
  mix: the packed arrays and budgets equal neko_tpu's Trainer's, four steps
  from its weights give its losses (both sides' train-mode patch positions
  set to the interval midpoint, the one draw neither can share), and a run
  resumed at step 2 replays the packed arrays and losses bit for bit.
"""

import dataclasses
import inspect
import json
import os
import pickle
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.cli.build import build_context as jax_build_context  # noqa: E402
from neko_tpu.training.arguments import TrainingArgs as JaxArgs  # noqa: E402
from neko_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402

from neko_tpu_torch import bench, convert  # noqa: E402
from neko_tpu_torch.cli import train as cli_train  # noqa: E402
from neko_tpu_torch.cli.build import build_context  # noqa: E402
from neko_tpu_torch.training.arguments import TrainingArgs  # noqa: E402
from neko_tpu_torch.training.trainer import Trainer  # noqa: E402
from neko_tpu_torch.utils.checkpoint import latest_checkpoint  # noqa: E402
from neko_tpu_torch.utils.host_state import load_host_state_for  # noqa: E402

from tests.test_torch_train import LOSS_TOL  # noqa: E402

CONTROL = ["neko-synth-continuous-v0", "neko-synth-discrete-v0",
           "neko-synth-multidiscrete-v0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module: its tensors are tiny, and in a
    parallel test run the thread pools of the workers contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_args(tmp_path, cls=TrainingArgs, **kw):
    defaults = dict(
        cpu=True, control_datasets=CONTROL, text_datasets=["synthetic"],
        text_datasets_paths=["synthetic"], text_prop=0.375, embed_dim=32, layers=1,
        heads=2, batch_size=8, sequence_length=64, training_steps=4, log_eval_freq=2,
        warmup_steps=2, learning_rate=1e-3, eval_episodes=0, eval_text_num_examples=0,
        mixed_precision="no", dropout=0.0, save_dir=str(tmp_path), log_jsonl=False,
        seed=0)
    defaults.update(kw)
    return cls(**defaults)


def make_trainer(tmp_path, name="exp", **kw):
    args = make_args(tmp_path, **kw)
    ctx, tasks = build_context(args)
    return Trainer(ctx, tasks, name, args)


def record(trainer):
    """Per-step losses and a copy of every packed batch, in order."""
    losses, stream = [], []
    sample, step = trainer._sample_arrays_locked, trainer.ctx.train_step

    def sampled():
        arrays = sample()
        stream.append({k: v.copy() for k, v in arrays.items()})
        return arrays

    def stepped(state, batch):
        state, loss = step(state, batch)
        losses.append(float(loss))
        return state, loss

    trainer._sample_arrays_locked = sampled
    trainer.ctx.train_step = stepped
    return losses, stream


def same_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_packed_stream_and_host_state_match_jax_trainer(tmp_path):
    kw = dict(control_datasets=CONTROL + ["neko-synth-image-v0"], batch_size=8)
    jargs = make_args(tmp_path, JaxArgs, **kw)
    jctx, jtasks = jax_build_context(jargs)
    jtr = JaxTrainer(jctx, jtasks, "jax", jargs)
    tr = make_trainer(tmp_path, **kw)
    assert (tr.patch_budget, tr.target_budget) == (jtr.patch_budget, jtr.target_budget)
    assert tr.patch_budget > 0
    for _ in range(7):  # the init draw, then 6 steps' batches
        same_arrays(tr.sample_arrays(), jtr.sample_arrays())
    assert pickle.dumps(tr.host_state()) == pickle.dumps(jtr.host_state())


def test_target_budget_matches_jax_when_gathered(tmp_path):
    kw = dict(text_prop=0.25, sequence_length=128, batch_size=8)
    jargs = make_args(tmp_path, JaxArgs, **kw)
    jtr = JaxTrainer(*jax_build_context(jargs), "jax", jargs)
    tr = make_trainer(tmp_path, **kw)
    assert 0 < tr.target_budget == jtr.target_budget
    for _ in range(3):
        same_arrays(tr.sample_arrays(), jtr.sample_arrays())


def test_four_trainer_steps_match_jax_from_its_weights(tmp_path):
    jargs = make_args(tmp_path, JaxArgs)
    jtr = JaxTrainer(*jax_build_context(jargs), "jax", jargs)
    jtr.init_state()
    jlosses = []
    jstep = jtr.ctx.train_step

    def jstepped(state, batch):
        state, loss = jstep(state, batch)
        jlosses.append(float(loss))
        return state, loss

    jtr.ctx.train_step = jstepped
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), jtr.ctx.model_cfg)
    tr = make_trainer(tmp_path)
    tr.init_state(sd)
    losses, _ = record(tr)
    jtr.train()
    tr.train()
    assert len(losses) == len(jlosses) == 4
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert losses[-1] < losses[0]


RESUME = dict(dropout=0.1, eval_episodes=1, eval_text_num_examples=2)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """4 steps with evaluation every 2: (losses, packed stream)."""
    tr = make_trainer(tmp_path_factory.mktemp("a"), **RESUME)
    tr.init_state()
    losses, stream = record(tr)
    tr.train()
    return losses, stream


def _resume(tmp_path, name, from_dir, **kw):
    """cli/train.py's --resume_from, through `run`."""
    args = make_args(tmp_path, **{**RESUME, **kw}, resume_from=from_dir)
    losses, stream = [], []
    orig = Trainer.train

    def train(self):
        losses[:], stream[:] = [], []
        ls, st = record(self)
        try:
            return orig(self)
        finally:
            losses.extend(ls)
            stream.extend(st)

    Trainer.train = train
    try:
        tr = cli_train.run(args, exp_name=name)
    finally:
        Trainer.train = orig
    return tr, losses, stream


def test_resume_replays_losses_and_stream(tmp_path, uninterrupted):
    losses_a, stream_a = uninterrupted
    b1 = make_trainer(tmp_path, "b1", **{**RESUME, "training_steps": 2, "save_model": True})
    b1.train()
    assert os.path.exists(os.path.join(b1.exp_dir, "checkpoint_2", "model.pt"))
    assert os.path.exists(os.path.join(b1.exp_dir, "host_state_2_p0.pkl"))
    tr, losses, stream = _resume(tmp_path, "b2", b1.exp_dir)
    assert tr.steps == 4
    assert losses == losses_a[2:4]  # bit for bit
    n = min(len(stream), len(stream_a) - 3)  # stream_a[0] is the init draw
    assert n >= 2
    for got, want in zip(stream[1:1 + n], stream_a[3:3 + n]):
        same_arrays(got, want)


def test_emergency_checkpoint_resumes_exactly(tmp_path, uninterrupted):
    losses_a, _ = uninterrupted
    tr = make_trainer(tmp_path, "em", **{**RESUME, "save_model": True})
    step = tr.ctx.train_step
    calls = []

    def dying(state, batch):
        if len(calls) == 3:
            raise KeyboardInterrupt("preempted")
        calls.append(1)
        return step(state, batch)

    tr.ctx.train_step = dying
    with pytest.raises(KeyboardInterrupt):
        tr.train()
    assert tr.state.step == 3 and latest_checkpoint(tr.exp_dir).endswith("checkpoint_3")
    resumed, losses, _ = _resume(tmp_path, "em2", tr.exp_dir)
    assert resumed.steps == 4 and losses == losses_a[3:4]


@pytest.mark.parametrize("where", ["inside the optimizer update", "before the host commit"])
def test_no_emergency_checkpoint_from_a_torn_state(tmp_path, uninterrupted, capsys, where):
    """Interrupted in step 3 after its parameters moved but before the step
    (or its host state) was counted: no checkpoint_2 of step-3 weights; the
    periodic checkpoint_2 stands and resumes exactly."""
    losses_a, _ = uninterrupted
    tr = make_trainer(tmp_path, "torn", **{**RESUME, "save_model": True,
                                           "save_mode": "checkpoint"})
    tr.init_state()
    if where == "inside the optimizer update":
        opt_step = tr.state.optimizer.step

        def dying_update(*a, **kw):
            opt_step(*a, **kw)
            if tr.state.step == 2:
                raise KeyboardInterrupt("preempted")

        tr.state.optimizer.step = dying_update
    else:
        step = tr.ctx.train_step

        def dying_step(state, batch):
            out = step(state, batch)
            if state.step == 3:
                raise KeyboardInterrupt("preempted")
            return out

        tr.ctx.train_step = dying_step
    saved = os.path.join(tr.exp_dir, "checkpoint_2", "model.pt")
    with pytest.raises(KeyboardInterrupt):
        tr.train()
    assert "no emergency checkpoint" in capsys.readouterr().out
    assert latest_checkpoint(tr.exp_dir).endswith("checkpoint_2")
    weights = torch.load(saved, map_location="cpu")
    assert not all(torch.equal(weights[k], v.detach())
                   for k, v in tr.state.model.state_dict().items())
    resumed, losses, _ = _resume(tmp_path, "torn2", tr.exp_dir)
    assert resumed.steps == 4 and losses == losses_a[2:4]


def test_evaluation_does_not_perturb_the_stream(tmp_path, uninterrupted):
    losses_a, stream_a = uninterrupted
    tr = make_trainer(tmp_path, **{**RESUME, "eval_episodes": 0, "eval_text_num_examples": 0})
    tr.init_state()
    losses, stream = record(tr)
    tr.train()
    assert losses == losses_a
    for got, want in zip(stream[:5], stream_a[:5]):
        same_arrays(got, want)


def test_save_model_refuses_several_prefetch_workers(tmp_path):
    with pytest.raises(ValueError, match="prefetch_workers"):
        make_trainer(tmp_path, save_model=True, prefetch_workers=2)
    make_trainer(tmp_path, save_model=False, prefetch_workers=2)  # no checkpoint: allowed


def test_resume_across_process_counts_raises_and_no_sidecar_is_approximate(tmp_path, capsys):
    src = make_trainer(tmp_path, "src", training_steps=2, save_model=True)
    src.train()
    ckpt = os.path.join(src.exp_dir, "checkpoint_2")
    # sidecars written by two processes: this one-process run cannot replay them
    two = os.path.join(tmp_path, "two")
    shutil.copytree(src.exp_dir, two)
    shutil.copy(os.path.join(two, "host_state_2_p0.pkl"), os.path.join(two, "host_state_2_p1.pkl"))
    with pytest.raises(ValueError, match="2 process"):
        load_host_state_for(os.path.join(two, "checkpoint_2"), 0, 1)
    with pytest.raises(ValueError, match="process"):
        cli_train.run(make_args(tmp_path, resume_from=two), exp_name="two_r")
    # and a one-process sidecar is refused by a two-process reader
    with pytest.raises(ValueError, match="1 process"):
        load_host_state_for(ckpt, 0, 2)
    # no sidecar at all: the device state resumes, the stream restarts
    bare = os.path.join(tmp_path, "bare")
    shutil.copytree(src.exp_dir, bare)
    os.remove(os.path.join(bare, "host_state_2_p0.pkl"))
    capsys.readouterr()
    tr = cli_train.run(make_args(tmp_path, resume_from=bare), exp_name="bare_r")
    assert tr.steps == 4
    assert "approximate resume" in capsys.readouterr().out


def test_checkpoint_holds_what_serving_and_resume_read(tmp_path):
    tr = make_trainer(tmp_path, training_steps=2, save_model=True, save_mode="last",
                      fused_adamw=True)
    tr.train()
    path = latest_checkpoint(tr.exp_dir)
    assert sorted(os.listdir(path)) == ["config.json", "model.pt", "train_state.pt"]
    cfg, model = convert.load_model_dir(path, device="cpu")
    assert cfg == tr.ctx.model_cfg
    for name, p in tr.state.model.named_parameters():
        torch.testing.assert_close(dict(model.named_parameters())[name], p, rtol=0, atol=0)
    saved = json.load(open(os.path.join(tr.exp_dir, "args.json")))
    assert saved["fused_adamw"] is True and saved["training_steps"] == 2
    args = make_args(tmp_path, fused_adamw=True, resume_from=path, training_steps=2)
    resumed = cli_train.run(args, exp_name="again")
    assert resumed.steps == 2 and resumed.state.optimizer.count == 2
    for a, b in zip(resumed.state.optimizer.fused_state().mu, tr.state.optimizer.fused_state().mu):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # --init_checkpoint: the weights alone, a fresh optimizer at step 0
    warm = make_trainer(tmp_path, "warm", fused_adamw=True, init_checkpoint=path)
    warm.init_state(cli_train.initial_weights(warm.args, warm.ctx))
    assert warm.state.step == 0 and warm.state.optimizer.count == 0
    for name, p in warm.state.model.named_parameters():
        torch.testing.assert_close(p, dict(model.named_parameters())[name], rtol=0, atol=0)


def test_evaluation_keeps_training_parameters_fp32_and_unchanged(tmp_path):
    tr = make_trainer(tmp_path, mixed_precision="bf16", eval_episodes=1,
                      eval_text_num_examples=2, control_datasets=CONTROL[:1])
    tr.init_state()
    before = {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()}
    logs = tr.evaluate()
    assert set(logs) >= {"evaluation/text/loss", "evaluation/neko-synth-continuous-v0/mean_return"}
    assert all(np.isfinite(v) for v in logs.values())
    for k, v in tr.state.model.state_dict().items():
        assert v.dtype == torch.float32, k
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    eval_model = tr._generator.model
    assert eval_model is not tr.state.model
    assert all(p.dtype == torch.bfloat16 for p in eval_model.parameters())
    # the copy follows the weights: after a step it is refreshed
    tr.train_step()
    tr.evaluate()
    w = tr.state.model.predict_token.weight
    torch.testing.assert_close(eval_model.predict_token.weight, w.to(torch.bfloat16))


def test_cli_refuses_what_is_not_ported(tmp_path):
    # the train CLI refuses no flag of neko_tpu's but a hub name in
    # --pretrained_lm (nothing is downloaded: a local directory only), and
    # --lora without --pretrained_lm, as neko_tpu refuses it
    for flag, error, match in (
            (["--pretrained_lm", "gpt2"], RuntimeError, "local GPT-2 directory only"),
            (["--lora", "--pretrained_lm", "gpt2"], RuntimeError, "hub name is not fetched"),
            (["--lora"], ValueError, "--lora requires --pretrained_lm"),
            (["--init_checkpoint", str(tmp_path / "absent.pt")], FileNotFoundError, "absent")):
        argv = ["--cpu", "--control_datasets", CONTROL[0], "--training_steps", "1",
                "--log_eval_freq", "1", "--save_dir", str(tmp_path)] + flag
        with pytest.raises(error, match=match):
            cli_train.main(argv)
    # training over processes is ported: --fsdp, --multihost and the 'model',
    # 'seq' and 'pipe' axes are no refusals; a 'model' or 'pipe' axis without
    # the ranks to carry it, layers that do not split into the stages, and
    # --multihost outside torchrun's environment are errors of use
    import neko_tpu_torch.training.arguments as arguments

    assert not hasattr(arguments, "not_ported")
    for flag, match in ((["--mesh_model_axis", "2"], "--multihost"),
                        (["--mesh_pipe_axis", "2"], "--multihost"),
                        (["--layers", "3", "--mesh_pipe_axis", "2"], "pipeline stages"),
                        (["--multihost"], "torchrun")):
        argv = ["--cpu", "--control_datasets", CONTROL[0], "--training_steps", "1",
                "--log_eval_freq", "1", "--save_dir", str(tmp_path)] + flag
        with pytest.raises(ValueError, match=match):
            cli_train.main(argv)
    with pytest.raises(NotImplementedError, match="Minari"):
        cli_train.main(["--cpu", "--control_datasets", "CartPole-v1", "--training_steps", "1",
                        "--log_eval_freq", "1"])
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        with pytest.raises(SystemExit):
            cli_train.main(["--control_datasets", CONTROL[0], "--training_steps", "1",
                            "--log_eval_freq", "1"])
    with pytest.raises(ValueError):  # the reference's startup checks
        cli_train.main(["--cpu", "--training_steps", "1", "--log_eval_freq", "1"])


FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures")
NEW_FLAGS = dict(
    control_datasets=[f"h5:{FIXTURES}/neko-synth-continuous-v0.h5:neko-synth-continuous-v0",
                      f"{FIXTURES}/neko-synth-dict-v0.h5"],
    layers=2, mixed_precision="fp16", stochastic_depth=0.1, remat=True, activation_fn="geglu",
    ema_decay=0.9, gradient_accumulation_steps=2, dropout=0.1, training_steps=5,
    log_eval_freq=3, save_model=True, save_mode="checkpoint", profile_steps=2)


def _trace_steps(trace_dir):
    with open(os.path.join(trace_dir, "trace_p0.json")) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("name") == "train_step" and e.get("cat") == "user_annotation"
               for e in events)


def test_every_new_flag_trains_and_resumes_mid_accumulation(tmp_path):
    from neko_tpu_torch.utils.checkpoint import EMA

    trace = str(tmp_path / "trace")
    recorded = []
    orig = Trainer.train

    def train(self):
        recorded.append(record(self)[0])
        return orig(self)

    Trainer.train = train
    try:
        tr = cli_train.run(make_args(tmp_path, **NEW_FLAGS, profile_dir=trace), exp_name="a")
    finally:
        Trainer.train = orig
    (losses_a,) = recorded
    cfg = tr.ctx.model_cfg
    assert (cfg.dtype, cfg.remat, cfg.activation_fn, cfg.stochastic_depth) == (
        "bfloat16", True, "geglu", 0.1)
    assert len(losses_a) == 5 and np.isfinite(losses_a).all()
    assert tr.state.step == 5 and tr.state.mini_step == 1 and tr.ctx.update_count(tr.state) == 2
    assert _trace_steps(trace) == 2
    mid = os.path.join(tr.exp_dir, "checkpoint_3")  # inside the second window
    assert torch.load(os.path.join(mid, "train_state.pt"), weights_only=True)["mini_step"] == 1
    resumed, losses, _ = _resume(tmp_path, "b", mid, **NEW_FLAGS)
    assert losses == losses_a[3:5]  # bit for bit
    assert resumed.state.mini_step == 1 and resumed.ctx.update_count(resumed.state) == 2
    end_a = os.path.join(tr.exp_dir, "checkpoint_5")
    end_b = os.path.join(resumed.exp_dir, "checkpoint_5")
    for name in ("model.pt", EMA):
        a = torch.load(os.path.join(end_a, name), weights_only=True)
        b = torch.load(os.path.join(end_b, name), weights_only=True)
        assert all(torch.equal(a[k], b[k]) for k in a), name


def test_profile_dir_traces_exactly_profile_steps(tmp_path):
    trace = str(tmp_path / "trace")
    tr = make_trainer(tmp_path, training_steps=6, log_eval_freq=6, profile_dir=trace,
                      profile_steps=3)
    tr.train()
    assert _trace_steps(trace) == 3 and tr._profiler is None
    # a run that ends inside the window still writes its trace
    short = str(tmp_path / "short")
    make_trainer(tmp_path, "short", training_steps=3, log_eval_freq=3, profile_dir=short,
                 profile_steps=3).train()
    assert _trace_steps(short) == 2


def test_args_parse_like_jax_and_round_trip_through_args_json(tmp_path):
    from neko_tpu.utils.typed_argparser import TypedArgumentParser as JaxParser

    from neko_tpu_torch.utils.typed_argparser import TypedArgumentParser

    argv = ["--cpu", "-k", "128", "--control_datasets", "a", "b", "--no_flash",
            "--save_model", "false", "--top_k", "3", "--fused_adamw"]
    (got,) = TypedArgumentParser(TrainingArgs).parse_args_into_dataclasses(argv)
    (want,) = JaxParser(JaxArgs).parse_args_into_dataclasses(argv)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g.pop("device") == "cuda" and w.pop("device") == "tpu"
    assert g == w
    tr = make_trainer(tmp_path, training_steps=1, log_eval_freq=1, save_model=True)
    tr.train()
    (again,) = TypedArgumentParser(TrainingArgs).parse_dict(
        json.load(open(os.path.join(tr.exp_dir, "args.json"))))
    assert again == tr.args


def test_bench_end_to_end_keys_at_a_tiny_config():
    shape = dict(embed_dim=32, layers=1, heads=2, batch_per_chip=3, context_len=76)
    cfg, ctx, state, batch, B = bench.setup(shape, "cpu", 0)
    out = bench.measure(ctx, state, batch, cfg, B, steps=1, warmup=1,
                        e2e=dict(steps=2, windows=1, warmup=1))
    assert set(out) == {"tokens_per_sec", "step_ms", "end_to_end", "e2e_over_device_step"}
    assert out["end_to_end"] > 0 and out["e2e_over_device_step"] > 0
    body = inspect.getsource(bench.main)  # the JSON line carries both
    assert '"end_to_end": round(m["end_to_end"]' in body
    assert '"e2e_over_device_step": round(m["e2e_over_device_step"]' in body


def test_prefetcher_many_workers_lose_no_batch_and_forward_errors():
    """More workers than cores on a shared, locked counter (the Trainer's
    sampling lock), with a short switch interval: every item reaches the
    consumer once; a worker's exception reaches get()."""
    import sys
    import threading

    from neko_tpu_torch.data.pipeline import HostPrefetcher

    lock, drawn = threading.Lock(), []

    def produce():
        with lock:
            drawn.append(len(drawn))
            return drawn[-1]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pf = HostPrefetcher(produce, depth=3, workers=2 * (os.cpu_count() or 4))
        got = [pf.get() for _ in range(500)]
        pf.close()
    finally:
        sys.setswitchinterval(old)
    assert len(set(got)) == 500 and set(got) <= set(drawn)
    assert not any(t.is_alive() for t in pf._threads)

    def boom():
        raise RuntimeError("sampling failed")

    pf = HostPrefetcher(boom, depth=1)
    with pytest.raises(RuntimeError, match="sampling failed"):
        pf.get()
    pf.close()


# ------------------------------------------------------ caption and VQA rows
def _image_args(tmp_path, cls=TrainingArgs, data="data", **kw):
    """The mix with caption and VQA rows, their data under tmp_path/<data>
    (a caption pool persists its split there: a second task over the same
    dir reads it and draws nothing, so each side gets its own copy)."""
    from tests.test_torch_caption_vqa import IMG, make_datasets, vqa_kwargs

    root = tmp_path / data
    if not (root / "caption").exists():
        make_datasets(root)
    v = vqa_kwargs(root)
    image = dict(
        caption_dataset=str(root / "caption"), vqa_dataset=str(root / "vqa"),
        vqa_train_data=v["train_data"], vqa_test_data=v["test_data"],
        train_img_name_prefix=v["train_img_name_prefix"],
        train_img_file_name_len=v["train_img_file_name_len"],
        test_img_name_prefix=v["test_img_name_prefix"],
        test_img_file_name_len=v["test_img_file_name_len"], caption_image_size=IMG,
        vqa_image_size=IMG, text_prop=0.25, caption_prop=0.25, vqa_prop=0.25,
        control_datasets=CONTROL[:2], test_data_prop=0.3)
    return make_args(tmp_path, cls, **{**image, **kw})


def _midpoint_patch_positions(monkeypatch):
    """Train-mode patch positions at the interval midpoint (eval mode's
    rule) on both sides: the JAX package draws them from jax.random, the
    port from the step's torch.Generator."""
    import types

    import jax.numpy as jnp

    from neko_tpu.models import embeddings as jax_embeddings

    from neko_tpu_torch.models.embeddings import PatchPosEncoding

    def mid(key, shape, lo, hi, *a, **kw):
        return jnp.round((lo + hi - 1) / 2.0).astype(jnp.int32)

    shim = types.SimpleNamespace(random=types.SimpleNamespace(split=jax.random.split,
                                                              randint=mid))
    monkeypatch.setattr(jax_embeddings, "jax", shim)
    monkeypatch.setattr(PatchPosEncoding, "sample", staticmethod(
        lambda lo, hi, g: torch.round((lo + torch.clamp(hi, min=lo + 1) - 1) / 2.0).long()))


def test_caption_vqa_rows_match_jax_trainer(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    _midpoint_patch_positions(monkeypatch)
    jargs = _image_args(tmp_path, JaxArgs, data="jax")
    jtr = JaxTrainer(*jax_build_context(jargs), "jax", jargs)
    args = _image_args(tmp_path, data="port")
    ctx, tasks = build_context(args)
    tr = Trainer(ctx, tasks, "port", args)
    assert [t.name for t in tr.tasks] == [t.name for t in jtr.tasks]
    assert tr.caption_tasks and tr.vqa_tasks and ctx.model_cfg.max_patches == 4
    assert (tr.patch_budget, tr.target_budget) == (jtr.patch_budget, jtr.target_budget)
    assert tr.patch_budget > 0
    for _ in range(3):
        same_arrays(tr.sample_arrays(), jtr.sample_arrays())
    assert pickle.dumps(tr.host_state()) == pickle.dumps(jtr.host_state())

    # four steps from neko_tpu's weights, fresh trainers on both sides
    jtr = JaxTrainer(*jax_build_context(jargs), "jax2", jargs)
    jtr.init_state()
    jlosses, jstep = [], jtr.ctx.train_step

    def jstepped(state, batch):
        state, loss = jstep(state, batch)
        jlosses.append(float(loss))
        return state, loss

    jtr.ctx.train_step = jstepped
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jtr.state.params), jtr.ctx.model_cfg)
    tr = Trainer(*build_context(args), "port2", args)
    tr.init_state(sd)
    losses, stream = record(tr)
    jtr.train()
    tr.train()
    assert len(losses) == len(jlosses) == 4
    assert all((a["patch_batch"] < args.batch_size).sum() >= 4 for a in stream)  # images
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)


def test_resume_with_caption_vqa_rows_replays_the_stream(tmp_path):
    pytest.importorskip("PIL")
    from neko_tpu_torch.cli.build import build_tasks

    # in-loop evaluation of the VQA task (its answer draws) alone
    kw = dict(dropout=0.1, eval_episodes=0, eval_text_num_examples=0,
              eval_caption_num_examples=0, eval_vqa_num_examples=2)
    build_tasks(_image_args(tmp_path, **kw))  # persists the caption split every run reads
    a = Trainer(*build_context(_image_args(tmp_path, **kw)), "a", _image_args(tmp_path, **kw))
    a.init_state()
    losses_a, stream_a = record(a)
    a.train()
    b1_args = _image_args(tmp_path, **kw, training_steps=2, save_model=True)
    b1 = Trainer(*build_context(b1_args), "b1", b1_args)
    b1.train()
    host = load_host_state_for(os.path.join(b1.exp_dir, "checkpoint_2"))
    assert [t["name"] for t in host["tasks"]][-2:] == ["caption", "vqa"]
    tr, losses, stream = _resume(tmp_path, "b2", b1.exp_dir, **{
        k: v for k, v in vars(_image_args(tmp_path, **kw)).items()
        if k not in RESUME and k != "resume_from"})
    assert tr.steps == 4 and losses == losses_a[2:4]
    n = min(len(stream), len(stream_a) - 3)
    assert n >= 2
    for got, want in zip(stream[1:1 + n], stream_a[3:3 + n]):
        same_arrays(got, want)
