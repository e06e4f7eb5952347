"""World-model walkthrough: VQ image codes and the observation-prediction
loss (counterpart of examples/world_model.py), offline on the synthetic
image env:

1. train a VQ-VAE on the env's frames (models/vq.py);
2. wrap the env: image obs -> MultiDiscrete code grids
   (envs/vq_wrapper.py), and re-encode its expert dataset;
3. train the model on the codes with --observation_loss through the
   Trainer, so observation tokens are loss targets;
4. roll the world model (`Generator.imagine`): given a history of real
   timesteps and the next actions, predict the next frames' codes, decode
   them, and report the next-frame code accuracy and the decoded-pixel MSE
   against the codes of the real next frame.

    python -m neko_tpu_torch.examples.world_model [--cpu]

On the CUDA device unless `--cpu` is given.  The sizes default to the JAX
walkthrough's (codebook 64 x 16, hidden 32, 200 VQ steps on 16 episodes; a
64d / 2-layer / 2-head model at k = 192, 8 rows, 200 steps); every one is a
flag, so a test runs it small.  The stages are functions of their own
(`train_tokenizer`, `world_model_task`, `train_world_model`, `dream`).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--episodes", type=int, default=16)
    p.add_argument("--codebook", type=int, default=64)
    p.add_argument("--code_dim", type=int, default=16)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--vq_steps", type=int, default=200)
    p.add_argument("--vq_lr", type=float, default=1e-3)
    p.add_argument("--embed_dim", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("-k", "--sequence_length", type=int, default=192)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--training_steps", type=int, default=200)
    p.add_argument("--history", type=int, default=6, help="real timesteps before the dream")
    p.add_argument("--dream", type=int, default=3, help="frames to imagine")
    return p


def train_tokenizer(env, episodes: int, vq_cfg, steps: int, lr: float, device):
    """Stage 1: the env's expert dataset and a VQVAE trained on its frames.
    -> (dataset, model, history)."""
    from neko_tpu_torch.envs.synthetic import collect_expert_dataset
    from neko_tpu_torch.envs.vq_wrapper import _to_float_rgb
    from neko_tpu_torch.models.vq import VQVAE
    from neko_tpu_torch.tools.train_vq import train

    ds = collect_expert_dataset(env, n_episodes=episodes, env_id="img")
    frames = np.stack([_to_float_rgb(o) for i in range(ds.total_episodes)
                       for o in np.asarray(ds.get_episode(i).observations)])
    vq = VQVAE(vq_cfg)
    history = train(vq, frames, steps, 32, lr, device, log_every=steps)
    return ds, vq, history


def world_model_task(env, ds, vq, device, context_len: int):
    """Stage 2: the wrapped env, the dataset as codes, and the control task
    over them.  -> (codec, wrapped env, code dataset, task)."""
    from neko_tpu_torch.envs.vq_wrapper import (VQImageCodec, VQObservationWrapper,
                                                encode_episode_dataset)
    from neko_tpu_torch.tasks.control import ControlTask

    codec = VQImageCodec(vq, device)
    wrapped = VQObservationWrapper(env, codec)
    vq_ds = encode_episode_dataset(ds, codec, env_id="vq-img")
    task = ControlTask("vq-img", wrapped, vq_ds, context_len=context_len, seed=0)
    return codec, wrapped, vq_ds, task


def world_model_args(**overrides):
    """The walkthrough's TrainingArgs (--observation_loss, no evaluation, no
    checkpoint), with `overrides`."""
    from neko_tpu_torch.training.arguments import TrainingArgs

    kw = dict(sequence_length=192, embed_dim=64, layers=2, heads=2, batch_size=8,
              text_prop=0.0, control_datasets=["vq-img"], text_datasets=[],
              text_datasets_paths=[], training_steps=200, log_eval_freq=50, eval_episodes=0,
              eval_text_num_examples=0, mixed_precision="no", save_model=False,
              log_jsonl=False, dropout=0.0, observation_loss=True, warmup_steps=20,
              learning_rate=3e-3)
    kw.update(overrides)
    return TrainingArgs(**kw)


def train_world_model(task, args):
    """Stage 3: the Trainer over the one task.  -> the trained Trainer."""
    from neko_tpu_torch.cli import build as B
    from neko_tpu_torch.training.trainer import Trainer

    ctx, _ = B.build_context(args, tasks=[task])
    trainer = Trainer(ctx, [task], "world_model", args)
    trainer.train()
    return trainer


def dream_generator(trainer):
    """A Generator over an activation-dtype copy of the trained weights."""
    from neko_tpu_torch.convert import build_model
    from neko_tpu_torch.inference.generator import Generator

    cfg = trainer.ctx.model_cfg
    sd = {k: v.detach().to(cfg.activation_dtype, copy=True)
          for k, v in trainer.state.model.state_dict().items()}
    return Generator(build_model(cfg, sd, trainer.ctx.device), trainer.packer)


def dream_inputs(vq_ds, H: int, K: int, episode: int = 0):
    """(history {discrete_obs, discrete_actions} of H real timesteps, the K
    next actions, the K real next frames' codes) of one episode."""
    ep = vq_ds.get_episode(episode)
    hist = {"discrete_obs": ep.observations[:H].astype(np.int32),
            "discrete_actions": np.asarray(ep.actions[:H], np.int32).reshape(H, -1)}
    acts = np.asarray(ep.actions[H:H + K], np.int32).reshape(K, -1)
    return hist, acts, np.asarray(ep.observations[H:H + K], np.int64)


def dream(gen, codec, vq_ds, grid, H: int, K: int) -> dict:
    """Stage 4: imagine K frames after H real ones; the first dreamed
    frame's code accuracy and decoded-pixel MSE against the real next
    frame's codes (decoded the same way)."""
    hist, acts, true_codes = dream_inputs(vq_ds, H, K)
    K_codes = codec.model.cfg.codebook_size
    pred = gen.imagine(hist, acts, obs_nvec=[K_codes] * (grid[0] * grid[1]))
    acc = float((pred[0] == true_codes[0]).mean())
    pred_img = codec.decode(pred[:1].astype(np.int64), grid)[0]
    true_img = codec.decode(true_codes[:1], grid)[0]
    return {"dream": pred, "accuracy": acc,
            "pixel_mse": float(np.mean((pred_img - true_img) ** 2))}


def main(argv: Optional[list] = None) -> dict:
    from neko_tpu_torch.envs.synthetic import SyntheticImageEnv
    from neko_tpu_torch.models.vq import VQConfig

    cli = parser().parse_args(argv)
    if not cli.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible (pass --cpu to run on the CPU)")
    device = torch.device("cpu" if cli.cpu else "cuda")

    env = SyntheticImageEnv()
    cfg = VQConfig(codebook_size=cli.codebook, code_dim=cli.code_dim, hidden=cli.hidden)
    ds, vq, history = train_tokenizer(env, cli.episodes, cfg, cli.vq_steps, cli.vq_lr, device)
    print(f"VQ trained: recon_mse {history['recon_mse'][-1]:.5f}")

    codec, wrapped, vq_ds, task = world_model_task(env, ds, vq, device, cli.sequence_length)
    grid = wrapped.grid
    print(f"obs space: {grid[0] * grid[1]} codes/frame, grid {grid}")

    args = world_model_args(
        cpu=cli.cpu, device="cpu" if cli.cpu else "cuda", sequence_length=cli.sequence_length,
        embed_dim=cli.embed_dim, layers=cli.layers, heads=cli.heads, batch_size=cli.batch_size,
        training_steps=cli.training_steps,
        log_eval_freq=max(1, min(50, cli.training_steps)),
        warmup_steps=min(20, cli.training_steps))
    trainer = train_world_model(task, args)

    res = dream(dream_generator(trainer), codec, vq_ds, grid, cli.history, cli.dream)
    print(f"dreamed {cli.dream} frames; next-frame code accuracy {res['accuracy']:.2f}, "
          f"decoded-pixel MSE {res['pixel_mse']:.5f}")
    print("world model OK" if res["accuracy"] > 1.0 / cfg.codebook_size else
          "world model under-trained (raise --training_steps)")
    return dict(res, vq_recon_mse=history["recon_mse"], grid=grid, steps=trainer.steps)


if __name__ == "__main__":
    main()
