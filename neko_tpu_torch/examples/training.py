"""Training walkthrough: a mixture with EMA, an exact resume, evaluation of
the EMA shadow, and the export of the run as a reference `.pt`
(counterpart of examples/training.py).  Runs offline end to end on the
synthetic control env and synthetic text:

    python -m neko_tpu_torch.examples.training [--cpu] [--save_dir DIR]

On the CUDA device unless `--cpu` is given.  The width and the step count
default to the JAX walkthrough's (64d / 2 layers / 4 heads, k = 128, 8
rows, 20 steps then a resume to 30); `--embed_dim`, `--layers`, `--heads`,
`-k`, `--batch_size` and `--steps` shrink it.  Everything is written under
`--save_dir` (default: a new temporary directory).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--save_dir", default=None, help="default: a new temporary directory")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("-k", "--sequence_length", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=20,
                   help="steps of the first run; the resume adds half as many")
    return p


def main(argv: Optional[list] = None) -> dict:
    from neko_tpu_torch.cli import evaluate
    from neko_tpu_torch.cli.train import run, validate_args
    from neko_tpu_torch.tools import export_checkpoint
    from neko_tpu_torch.training.arguments import TrainingArgs

    cli = parser().parse_args(argv)
    save_dir = cli.save_dir or tempfile.mkdtemp(prefix="neko_training_example_")
    device = dict(cpu=True, device="cpu") if cli.cpu else {}

    # 1. mixture training (half text, half control), EMA on
    common = dict(
        control_datasets=["neko-synth-continuous-v0"], text_prop=0.5,
        text_datasets=["synthetic"], text_datasets_paths=["synthetic"],
        embed_dim=cli.embed_dim, layers=cli.layers, heads=cli.heads,
        batch_size=cli.batch_size, sequence_length=cli.sequence_length, warmup_steps=5,
        mixed_precision="no", dropout=0.0, eval_episodes=1, eval_text_num_examples=2,
        save_model=True, save_mode="checkpoint", save_dir=save_dir, ema_decay=0.95,
        **device)
    half = max(cli.steps // 2, 1)
    args = TrainingArgs(training_steps=cli.steps, log_eval_freq=half, **common)
    validate_args(args)
    print(f"=== 1: train {cli.steps} steps (mixture, EMA) ===")
    trainer = run(args, exp_name="example_train")
    ckpt = os.path.join(trainer.exp_dir, f"checkpoint_{cli.steps}")
    print(f"checkpointed: {ckpt}")

    # 2. exact resume: the run ends at training_steps, the data stream and
    # the optimizer state continue as if it had never stopped
    print(f"=== 2: resume to step {cli.steps + half} ===")
    args2 = TrainingArgs(training_steps=cli.steps + half, log_eval_freq=half,
                         resume_from=ckpt, **common)
    validate_args(args2)
    trainer2 = run(args2, exp_name="example_resume")

    # 3. evaluate the EMA shadow
    print("=== 3: evaluate with --use_ema ===")
    logs = evaluate.main(["--model_path", trainer2.exp_dir, "--use_ema", "--eval_episodes",
                          "1", "--eval_text_num_examples", "2"] + (["--cpu"] if cli.cpu else []))
    if not any(k.startswith("evaluation/") for k in logs):
        raise RuntimeError("the evaluation logged nothing")

    # 4. export for the reference framework
    print("=== 4: export a reference-loadable .pt ===")
    out = export_checkpoint.main(["--model_path", trainer2.exp_dir, "--out",
                                  os.path.join(save_dir, "reference_checkpoint.pt")])
    return {"exp_dir": trainer2.exp_dir, "steps": trainer2.steps, "evaluation": logs,
            "reference_checkpoint": out}


if __name__ == "__main__":
    main()
