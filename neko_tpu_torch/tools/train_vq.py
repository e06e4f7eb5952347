"""Train the VQ-VAE image tokenizer (models/vq.py) offline (counterpart of
tools/train_vq.py).

    python -m neko_tpu_torch.tools.train_vq --out /tmp/vq_ckpt [--steps 400]
        [--dataset neko-synth-image-v0] [--codebook 512] [--cpu]

Collects the frames of a control dataset's episodes (the synthetic image env
by default), trains the VQ-VAE, reports the reconstruction MSE and the
codebook perplexity, and writes `vq_config.json` (the VQConfig fields) and
`vq_state.pt` (the state dict: weights and codebook) under `--out`.
`load_vq(path)` reads them back; use the model through `envs/vq_wrapper.py`
(wrap an image env, re-encode an episode dataset).  On the CUDA device
unless `--cpu` is given (no fallback).  The JAX package writes an Orbax
directory, which this package does not read: carry its variables across
with `convert.jax_vq_variables_to_state_dict`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from neko_tpu_torch.models.vq import VQConfig, VQVAE, adam, make_train_step

CONFIG = "vq_config.json"
STATE = "vq_state.pt"


def load_vq(path: str, device="cuda") -> VQVAE:
    """The VQVAE saved under `path`, on `device`, in eval mode."""
    with open(os.path.join(path, CONFIG)) as fh:
        cfg = VQConfig(**json.load(fh))
    model = VQVAE(cfg)
    model.load_state_dict(torch.load(os.path.join(path, STATE), map_location="cpu",
                                     weights_only=True))
    return model.to(device).eval()


def save_vq(path: str, model: VQVAE) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG), "w") as fh:
        json.dump(dataclasses.asdict(model.cfg), fh)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(path, STATE))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", default="neko-synth-image-v0")
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--codebook", type=int, default=512)
    p.add_argument("--code_dim", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    return p


def dataset_frames(name: str, episodes: int) -> np.ndarray:
    """float32 [N, H, W, 3] frames in [0, 1] of every episode of the dataset."""
    from neko_tpu_torch.envs.setup_env import load_env_dataset
    from neko_tpu_torch.envs.vq_wrapper import _to_float_rgb

    _, dataset = load_env_dataset(name, {"n_episodes": episodes})
    return np.stack([_to_float_rgb(o) for i in range(dataset.total_episodes)
                     for o in np.asarray(dataset.get_episode(i).observations)])


def train(model: VQVAE, frames: np.ndarray, steps: int, batch: int, lr: float,
          device, log_every: Optional[int] = None) -> dict:
    """`steps` Adam steps on batches of `batch` frames drawn with
    np.random.RandomState(0) (the JAX tool's draw), the dead-code restarts
    from a torch.Generator seeded 0.  -> {"recon_mse": per step,
    "perplexity": per step} (floats)."""
    model.to(device)
    step = make_train_step(model, adam(model, lr))
    images = torch.from_numpy(frames).to(device)
    g = torch.Generator(device=device).manual_seed(0)
    npr = np.random.RandomState(0)
    log_every = log_every or max(1, steps // 5)
    history = {"recon_mse": [], "perplexity": []}
    for i in range(steps):
        idx = torch.from_numpy(npr.randint(0, len(frames), size=batch)).to(device)
        m = step(images[idx], g)
        for k in history:
            history[k].append(m[k])
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i}: recon_mse {float(m['recon_mse']):.5f} "
                  f"perplexity {float(m['perplexity']):.1f}")
    return {k: [float(v) for v in vs] for k, vs in history.items()}


def main(argv: Optional[list] = None) -> dict:
    cli = parser().parse_args(argv)
    if not cli.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible (pass --cpu to train on the CPU)")
    device = torch.device("cpu" if cli.cpu else "cuda")
    frames = dataset_frames(cli.dataset, cli.episodes)
    print(f"{len(frames)} frames {frames.shape[1:]} from {cli.dataset}")
    model = VQVAE(VQConfig(codebook_size=cli.codebook, code_dim=cli.code_dim,
                           hidden=cli.hidden))
    history = train(model, frames, cli.steps, cli.batch, cli.lr, device)
    first, last = history["recon_mse"][0], history["recon_mse"][-1]
    print(f"recon_mse {first:.5f} -> {last:.5f}")
    save_vq(cli.out, model)
    print(f"saved {cli.out}")
    return dict(history, out=cli.out, frames=len(frames))


if __name__ == "__main__":
    main()
