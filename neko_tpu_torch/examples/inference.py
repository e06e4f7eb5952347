"""Inference walkthrough: restore a checkpoint and use the Generator's
prediction interfaces (counterpart of examples/inference.py).  Runs offline
end to end:

    python -m neko_tpu_torch.examples.inference [--cpu]        # trains a tiny model first
    python -m neko_tpu_torch.examples.inference --model_path runs/<exp> [--cpu]

On the CUDA device unless `--cpu` is given.  Without `--model_path` it
first trains a model of `--embed_dim` / `--layers` / `--heads` (default the
JAX walkthrough's 64d / 2 / 4, k = 128, `--steps` 30) on synthetic text and
a synthetic control env, in a new temporary directory (or `--save_dir`).
Serving over 'model' ranks needs torchrun: `python -m neko_tpu_torch.cli.serve
--mesh_model_axis N` (README).
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

import numpy as np


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None,
                   help="experiment dir or checkpoint_<N> dir; default: train a tiny model")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--save_dir", default=None)
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("-k", "--sequence_length", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    return p


def train_tiny(cli) -> str:
    from neko_tpu_torch.cli.train import run, validate_args
    from neko_tpu_torch.training.arguments import TrainingArgs

    args = TrainingArgs(
        control_datasets=["neko-synth-continuous-v0"], text_prop=0.5,
        text_datasets=["synthetic"], text_datasets_paths=["synthetic"],
        embed_dim=cli.embed_dim, layers=cli.layers, heads=cli.heads, batch_size=8,
        sequence_length=cli.sequence_length, training_steps=cli.steps,
        log_eval_freq=cli.steps, warmup_steps=5, mixed_precision="no", dropout=0.0,
        eval_episodes=0, eval_text_num_examples=2, save_model=True, save_mode="checkpoint",
        save_dir=cli.save_dir or tempfile.mkdtemp(prefix="neko_inference_example_"),
        **(dict(cpu=True, device="cpu") if cli.cpu else {}))
    validate_args(args)
    return run(args, exp_name="example_model").exp_dir


def main(argv: Optional[list] = None) -> dict:
    import torch

    from neko_tpu_torch.cli.build import build_context, load_state_for, resolve_checkpoint_and_args
    from neko_tpu_torch.envs.setup_env import load_env_dataset
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.tasks.control import ControlTask

    cli = parser().parse_args(argv)
    model_path = cli.model_path
    if model_path is None:
        print("=== training a tiny model on synthetic data ===")
        model_path = train_tiny(cli)

    # restore the checkpoint as the evaluation CLI does
    device = {"cpu": True, "device": "cpu"} if cli.cpu else {"cpu": False, "device": "cuda"}
    ckpt, args = resolve_checkpoint_and_args(model_path, device)
    ctx, _ = build_context(args, tasks=[], ckpt_path=ckpt)
    model, packer = load_state_for(ctx, ckpt)
    gen = Generator(model, packer, seed=0)
    ts = ctx.model_cfg.token_space
    text = dict(start=ts.start("text"), end=ts.end("text"))
    print(f"loaded {ckpt} on {ctx.device}")
    out = {}

    # 1. text continuation, greedy and sampled
    prompt = [12, 42, 7]
    _, tokens = gen.predict_text({"text": prompt}, max_length=8)
    out["predict_text"] = [int(t) for t in tokens]
    _, sampled = gen.predict_text({"text": prompt}, max_length=8, deterministic=False,
                                  generator=torch.Generator(ctx.device).manual_seed(0),
                                  temperature=0.8, top_k=50, top_p=0.95)
    out["predict_text_sampled"] = [int(t) for t in sampled]

    # 2. a control action (continuous)
    obs = np.random.RandomState(0).randn(3, 8).astype(np.float32)
    act = np.zeros((3, 2), np.float32)
    out["predict_control"] = np.asarray(gen.predict_control(
        {"continuous_obs": obs, "continuous_actions": act}, action_kind="continuous",
        action_tokens=2)).tolist()

    # 3. batched generation, and lossless speculation (prompt lookup, and the
    # target's own first layer as a draft)
    toks, _ = gen.generate_batch([{"text": [1, 2]}, {"text": [3, 4, 5]}], max_new_tokens=4,
                                 **text)
    out["generate_batch"] = np.asarray(toks).tolist()
    spec, rounds = gen.generate_spec({"text": prompt}, max_new_tokens=8, speculate_k=4,
                                     **text)
    out["generate_spec"] = (np.asarray(spec).tolist(), int(rounds))
    if ctx.model_cfg.layers > 1:
        spec_d, rounds_d = gen.generate_spec_draft({"text": prompt}, gen.truncated_draft(1),
                                                   max_new_tokens=8, speculate_k=4, **text)
        out["generate_spec_draft"] = (np.asarray(spec_d).tolist(), int(rounds_d))

    # 4. a live env rollout through the rollout cache
    env, ds = load_env_dataset("neko-synth-continuous-v0", {"horizon": 8})
    task = ControlTask("demo", env, ds, context_len=args.sequence_length, seed=0)
    out["rollout"] = task.evaluate(gen, n_iterations=2, parallel_episodes=2)

    # 5. serving options: the int8 KV cache, fp8 weights, the continuous engine
    ctx8, _ = build_context(dataclasses.replace(args, kv_cache_dtype="int8"), tasks=[],
                            ckpt_path=ckpt)
    gen8 = Generator(load_state_for(ctx8, ckpt)[0], packer, seed=0)
    out["predict_text_int8_cache"] = [int(t) for t in gen8.predict_text(
        {"text": prompt}, max_length=8)[1]]
    fp8, _ = load_state_for(ctx, ckpt, weight_dtype="fp8")
    genf8 = Generator(fp8, packer, seed=0, weight_dtype="fp8")
    out["predict_text_fp8"] = [int(t) for t in genf8.predict_text({"text": prompt},
                                                                  max_length=8)[1]]
    st = gen.engine_admit(gen.engine_init(2), 0, {"text": prompt})
    ones = np.ones(2, np.float32)
    toks_e, _ = gen.engine_chunk(st, n_steps=8, det=np.ones(2, bool), temp=ones, top_p=ones,
                                 **text)
    out["engine_slot_0"] = np.asarray(toks_e[0]).tolist()
    for k, v in out.items():
        print(f"{k} -> {v}")
    return out


if __name__ == "__main__":
    main()
