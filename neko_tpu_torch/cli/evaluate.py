"""`python -m neko_tpu_torch.cli.evaluate` -- standalone evaluation
(counterpart of neko_tpu/cli/evaluate.py, `python eval.py`).

    python -m neko_tpu_torch.cli.evaluate --model_path DIR [--cpu]

DIR is a checkpoint_<N> dir written by `python -m neko_tpu_torch.cli.train`,
or its experiment dir (the latest checkpoint is used).  The run's args.json
is loaded and the flags given here override it; the envs and tasks are
rebuilt from it, the checkpoint's weights restored into a model on the CUDA
device (`--cpu` for the CPU: without either there is no fallback), and the
control, text, caption and VQA tasks evaluated through the KV-cache
Generator, printing `evaluation/<task>/<metric>: value` lines.  `--use_ema`
evaluates the checkpoint's EMA shadow (`ema.pt`) in place of its weights.
Control episodes run in lockstep (`--eval_parallel_episodes`, 0 = auto),
serially with `--render`; the sampling knobs apply with `--eval_mode
stochastic`.  `--kv_cache_dtype int8` and `--serve_weight_dtype fp8`
evaluate through the int8 cache and fp8 weights of serving.

Tensor-parallel, N ranks under torchrun (the JAX package's
`--mesh_model_axis`):

    torchrun --nproc_per_node N -m neko_tpu_torch.cli.evaluate --model_path DIR \
        --mesh_model_axis N

Every rank restores its block of the weights, builds the same tasks from
the same seeds and evaluates them in lockstep (each Generator call runs its
collectives on every rank); rank 0 prints.
"""

from __future__ import annotations

import argparse
from typing import Optional

from neko_tpu_torch.cli.build import (build_context, load_state_for,
                                      resolve_checkpoint_and_args, serving_ranks)
from neko_tpu_torch.inference.generator import Generator
from neko_tpu_torch.parallel.multihost import process_index
from neko_tpu_torch.training.trainer import evaluate_task

# flags merged into the saved args when given
OVERRIDES = ("eval_episodes", "eval_mode", "promptless_eval", "eval_text_num_examples",
             "eval_text_log_examples", "top_k", "eval_parallel_episodes", "kv_cache_dtype")


def _or(value, default):
    return default if value is None else value


def run(cli) -> dict:
    overrides = {key: getattr(cli, key, None) for key in OVERRIDES}
    ckpt_path, args = resolve_checkpoint_and_args(cli.model_path, overrides)
    # the device is this command's, never the training run's
    args.cpu, args.device = bool(cli.cpu), ("cpu" if cli.cpu else "cuda")
    if cli.control_datasets:
        args.control_datasets = cli.control_datasets
    render = bool(getattr(cli, "render", False))
    tasks = None
    if render and args.control_datasets:
        # the JAX package rebuilds the envs with a human render window and
        # evaluates control and text serially; the port's synthetic envs
        # draw no window (as the JAX package's), so what remains is that
        from neko_tpu_torch.cli.build import build_tasks
        from neko_tpu_torch.tasks.control import ControlTask
        from neko_tpu_torch.tasks.text import TextTask

        tasks = [t for t in build_tasks(args) if isinstance(t, (ControlTask, TextTask))]

    ranks = serving_ranks(getattr(cli, "mesh_model_axis", None), bool(cli.cpu))
    ctx, tasks = build_context(args, tasks=tasks, ckpt_path=ckpt_path, ranks=ranks)
    weight_dtype = getattr(cli, "serve_weight_dtype", None)
    model, packer = load_state_for(ctx, ckpt_path, use_ema=bool(getattr(cli, "use_ema", False)),
                                   weight_dtype=weight_dtype)
    gen = Generator(
        model, packer, seed=args.seed,
        temperature=_or(getattr(cli, "temperature", None), 1.0),
        top_k=_or(getattr(cli, "sample_top_k", None), 0),
        top_p=_or(getattr(cli, "sample_top_p", None), 1.0),
        weight_dtype=weight_dtype,
    )
    deterministic = args.eval_mode == "deterministic"
    logs = {}
    for task in tasks:
        logs.update(evaluate_task(task, gen, args, deterministic,
                                  parallel_episodes=1 if render else None))
    if process_index() == 0:
        for k, v in logs.items():
            print(f"{k}: {v}")
    return logs


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, required=True,
                   help="checkpoint_<N> dir, or an exp dir (latest used)")
    p.add_argument("--eval_episodes", type=int, default=None)
    p.add_argument("--eval_parallel_episodes", type=int, default=None,
                   help="lockstep-batched episodes per device call; 0=auto")
    p.add_argument("--eval_mode", type=str, default=None,
                   choices=["deterministic", "stochastic"])
    p.add_argument("--promptless_eval", action="store_true", default=None)
    p.add_argument("--eval_text_num_examples", type=int, default=None)
    p.add_argument("--eval_text_log_examples", action="store_true", default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None,
                   help="sampling temperature for --eval_mode=stochastic")
    p.add_argument("--sample_top_k", type=int, default=None,
                   help="top-k sampling filter (0=off); distinct from --top_k, which "
                        "selects prompt episodes by return")
    p.add_argument("--sample_top_p", type=float, default=None,
                   help="nucleus sampling mass (1.0=off)")
    p.add_argument("--use_ema", action="store_true", default=False,
                   help="evaluate the EMA shadow params (a checkpoint of a run with "
                        "--ema_decay > 0)")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="run on the CPU (default: the CUDA device, which must be visible)")
    p.add_argument("--mesh_model_axis", type=int, default=None,
                   help="tensor-parallel degree: that many ranks under torchrun")
    p.add_argument("--serve_weight_dtype", type=str, default=None, choices=["bf16", "fp8"],
                   help="fp8: e4m3 matmul weights with per-channel scales")
    p.add_argument("--kv_cache_dtype", type=str, default=None, choices=["native", "int8"],
                   help="int8: KV caches of int8 rows with fp32 row scales")
    p.add_argument("--control_datasets", type=str, nargs="+", default=None)
    p.add_argument("--render", action="store_true", default=False,
                   help="render control envs during evaluation (serial episodes)")
    return p


def main(argv: Optional[list] = None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
