"""Inspect a checkpoint of this package: step, parameter counts, shapes and
EMA presence (counterpart of tools/inspect_checkpoint.py).

    python -m neko_tpu_torch.tools.inspect_checkpoint --model_path runs/<exp> [--tree]

Reads the checkpoint's files on the CPU (`model.pt`, `train_state.pt`,
`config.json`, the run's args.json): no model is built.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True,
                   help="checkpoint_<N> dir, or an experiment dir (latest used)")
    p.add_argument("--tree", action="store_true",
                   help="print every tensor's name, shape and dtype")
    return p


def summary(path: str) -> dict:
    """{"checkpoint", "step", "sections": {module: (values, tensors)},
    "parameters", "optimizer_entries", "ema", "shapes"} of a checkpoint dir."""
    from neko_tpu_torch.utils import checkpoint as ckpt

    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)
    ts = torch.load(os.path.join(path, ckpt.TRAIN_STATE), map_location="cpu",
                    weights_only=True)
    sections: dict = {}
    for key, t in sd.items():
        n, k = sections.get(key.split(".")[0], (0, 0))
        sections[key.split(".")[0]] = (n + t.numel(), k + 1)
    return {"checkpoint": path, "step": int(ts["step"]), "sections": sections,
            "parameters": sum(t.numel() for t in sd.values()),
            "optimizer_entries": len(ts["optimizer"].get("state", {})),
            "ema": os.path.isfile(os.path.join(path, ckpt.EMA)),
            "shapes": {k: (tuple(t.shape), str(t.dtype)) for k, t in sd.items()}}


def main(argv: Optional[list] = None) -> dict:
    from neko_tpu_torch.utils import checkpoint as ckpt

    cli = parser().parse_args(argv)
    path = ckpt.resolve_checkpoint_dir(cli.model_path)
    info = summary(path)
    print(f"checkpoint: {path}")
    print(f"step: {info['step']}")
    try:
        args = ckpt.load_args_dict(os.path.dirname(os.path.abspath(path)))
        print(f"run args: embed_dim={args.get('embed_dim')} layers={args.get('layers')} "
              f"heads={args.get('heads')} k={args.get('sequence_length')} "
              f"seed={args.get('seed')} pretrained_lm={args.get('pretrained_lm')}")
    except FileNotFoundError:
        pass
    cfg = ckpt.saved_model_config(path)
    print(f"model: {cfg.embed_dim}d / {cfg.layers} layers / {cfg.heads} heads "
          f"(hd {cfg.head_dim}), k={cfg.context_len}, lora_r={cfg.lora_r}")
    for name in sorted(info["sections"]):
        n, k = info["sections"][name]
        print(f"  {name:<24} {n:>14,} values ({k} tensors)")
    print(f"parameters: {info['parameters']:,}")
    print(f"optimizer state: {info['optimizer_entries']} entries")
    print("ema shadow: present (evaluate with --use_ema)" if info["ema"] else "ema shadow: none")
    if cli.tree:
        for name, (shape, dtype) in info["shapes"].items():
            print(f"  {name}  {shape} {dtype}")
    return info


if __name__ == "__main__":
    main()
