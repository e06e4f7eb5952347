"""The checkpoint tools and the two example walkthroughs of neko_tpu_torch on
the CPU, each run through `python -m`:

* `tools.average_checkpoints`: the weights and the EMA shadow are the
  weighted mean of the inputs' (weights normalized; within 1e-6 of a
  float64 mean), the step and the optimizer state the last input's, and
  the average restores through the evaluation CLI and the serve CLI's
  build, which answers a request;
* `tools.inspect_checkpoint`: the step, the parameter count (the model's,
  from `convert.model_shapes`) and the EMA shadow;
* `examples.training` and `examples.inference` at a tiny width.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neko_tpu_torch.cli import train as cli_train  # noqa: E402
from neko_tpu_torch.convert import model_shapes  # noqa: E402
from neko_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ["--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
         "--text_prop", "0.5", "--control_datasets", "neko-synth-continuous-v0",
         "--embed_dim", "32", "--layers", "1", "--heads", "2", "-k", "64", "--batch_size", "4",
         "--training_steps", "4", "--log_eval_freq", "2", "--mixed_precision", "no",
         "--learning_rate", "1e-2", "--warmup_steps", "1", "--ema_decay", "0.5",
         "--eval_episodes", "0", "--eval_text_num_examples", "1", "--save_model",
         "--save_mode", "checkpoint"]
AVG_TOL = dict(rtol=0, atol=1e-6)
TINY_EXAMPLE = ["--cpu", "--embed_dim", "32", "--layers", "2", "--heads", "2", "-k", "64"]


def python_m(module, *argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", HF_HUB_OFFLINE="1")
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    base = tmp_path_factory.mktemp("tools")
    return cli_train.main(TRAIN + ["--save_dir", str(base)]).exp_dir


def _load(path, name):
    return torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)


def test_average_is_the_weighted_mean_and_restores(run, tmp_path):
    from neko_tpu_torch.cli import evaluate
    from neko_tpu_torch.cli import serve as cli_serve

    a, b = (os.path.join(run, f"checkpoint_{n}") for n in (2, 4))
    out = tmp_path / "soup"
    python_m("neko_tpu_torch.tools.average_checkpoints", "--checkpoints", a, b,
             "--weights", "1", "3", "--out", str(out))
    soup = out / "checkpoint_4"
    assert (out / "args.json").is_file()
    for name in ("model.pt", "ema.pt"):
        sa, sb, got = _load(a, name), _load(b, name), _load(soup, name)
        assert set(got) == set(sa)
        moved = 0.0
        for k, v in got.items():
            want = 0.25 * sa[k].double() + 0.75 * sb[k].double()
            np.testing.assert_allclose(v.numpy(), want.numpy(), err_msg=f"{name} {k}",
                                       **AVG_TOL)
            moved = max(moved, (sa[k] - sb[k]).abs().max().item())
        assert moved > 1e-3  # the inputs differ: the mean is no copy
    last, got = _load(b, ckpt.TRAIN_STATE), _load(soup, ckpt.TRAIN_STATE)
    assert got["step"] == 4 and got.keys() == last.keys()
    for i, entry in last["optimizer"]["state"].items():
        for f, t in entry.items():
            assert torch.equal(got["optimizer"]["state"][i][f], t), (i, f)

    logs = evaluate.main(["--model_path", str(out), "--cpu", "--use_ema",
                          "--eval_text_num_examples", "1"])
    assert np.isfinite(logs["evaluation/text/loss"])
    gen = cli_serve.build_generator(cli_serve.parser().parse_args(
        ["--model_path", str(out), "--cpu"]))
    ts = gen.cfg.token_space
    tokens, _ = gen.generate_batch([{"text": [5, 6, 7]}], max_new_tokens=3,
                                   start=ts.start("text"), end=ts.end("text"))
    assert np.asarray(tokens).shape == (1, 3)


def test_inspect_reports_the_counts(run):
    path = ckpt.resolve_checkpoint_dir(run)
    out = python_m("neko_tpu_torch.tools.inspect_checkpoint", "--model_path", run, "--tree")
    n = sum(s.numel() for s in model_shapes(ckpt.saved_model_config(path)).values())
    assert f"parameters: {n:,}" in out and "step: 4" in out
    assert "ema shadow: present" in out and "transformer.h.0.attn.c_attn.weight" in out


def test_the_examples_run_on_the_cpu(tmp_path):
    out = python_m("neko_tpu_torch.examples.training", *TINY_EXAMPLE, "--batch_size", "4",
                   "--steps", "2", "--save_dir", str(tmp_path / "train"))
    pt = tmp_path / "train" / "reference_checkpoint.pt"
    assert pt.is_file() and "=== 4: export" in out
    assert "embed_token.weight" in torch.load(pt, weights_only=True)
    out = python_m("neko_tpu_torch.examples.inference", *TINY_EXAMPLE, "--steps", "2",
                   "--save_dir", str(tmp_path / "infer"))
    for key in ("predict_text ->", "generate_spec_draft ->", "rollout ->",
                "predict_text_fp8 ->", "engine_slot_0 ->"):
        assert key in out, out[-2000:]
    assert json.loads((tmp_path / "infer" / "example_model" / "args.json").read_text())[
        "embed_dim"] == 32
