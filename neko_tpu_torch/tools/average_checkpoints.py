"""Average N checkpoints of this package into one (a model soup, trajectory
averaging; counterpart of tools/average_checkpoints.py).

    python -m neko_tpu_torch.tools.average_checkpoints \\
        --checkpoints runs/<exp>/checkpoint_100 runs/<exp>/checkpoint_200 \\
        --out runs/<exp>_soup [--weights 0.3 0.7]

Writes <out>/checkpoint_<step> and <out>/args.json, which `python -m
neko_tpu_torch.cli.evaluate` and `cli.serve` restore as any training
checkpoint: the weights averaged with the weights normalized to sum to 1
(fp32, in the order given), the step and the optimizer state those of the
last checkpoint listed, the EMA shadows averaged when every input has one.
Every input must hold the same model configuration.  Runs on the CPU: no
model is built.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict, List, Optional

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoints", nargs="+", required=True,
                   help="two or more checkpoint_<N> dirs (one model configuration)")
    p.add_argument("--weights", nargs="+", type=float, default=None,
                   help="a weight a checkpoint (default: uniform); normalized to sum to 1")
    p.add_argument("--out", required=True, help="output experiment dir")
    return p


def normalized(weights: Optional[List[float]], n: int) -> List[float]:
    if n < 2:
        raise ValueError("need at least two checkpoints")
    if weights is None:
        return [1.0 / n] * n
    if len(weights) != n:
        raise ValueError(f"{len(weights)} weights for {n} checkpoints")
    total = sum(weights)
    return [w / total for w in weights]


def average(state_dicts: List[Dict[str, torch.Tensor]],
            weights: List[float]) -> Dict[str, torch.Tensor]:
    """sum_i weights[i] * state_dicts[i], leaf by leaf in fp32, in the first
    one's dtype."""
    out = {}
    for key, first in state_dicts[0].items():
        acc = first.float() * weights[0]
        for w, sd in zip(weights[1:], state_dicts[1:]):
            acc = acc + sd[key].float() * w
        out[key] = acc.to(first.dtype)
    return out


def main(argv: Optional[list] = None) -> str:
    from neko_tpu_torch.convert import save_model_dir
    from neko_tpu_torch.utils import checkpoint as ckpt

    cli = parser().parse_args(argv)
    weights = normalized(cli.weights, len(cli.checkpoints))
    paths = [ckpt.resolve_checkpoint_dir(c) for c in cli.checkpoints]
    cfg = ckpt.saved_model_config(paths[-1])
    params, emas = [], []
    for path in paths:
        params.append(ckpt.load_params_only(path, cfg))  # raises on another configuration
        ema = os.path.join(path, ckpt.EMA)
        emas.append(torch.load(ema, map_location="cpu", weights_only=True)
                    if os.path.isfile(ema) else None)
        print(f"loaded {path}")
    last = paths[-1]
    train_state = torch.load(os.path.join(last, ckpt.TRAIN_STATE), map_location="cpu",
                             weights_only=True)
    step = int(train_state["step"])
    os.makedirs(cli.out, exist_ok=True)
    args_json = os.path.join(os.path.dirname(os.path.abspath(last)), "args.json")
    if os.path.isfile(args_json) and not os.path.exists(os.path.join(cli.out, "args.json")):
        shutil.copy(args_json, os.path.join(cli.out, "args.json"))
    out = os.path.join(os.path.abspath(cli.out), f"checkpoint_{step}")
    save_model_dir(out, cfg, average(params, weights))
    shutil.copy(os.path.join(last, ckpt.TRAIN_STATE), os.path.join(out, ckpt.TRAIN_STATE))
    if all(e is not None for e in emas):
        torch.save(average(emas, weights), os.path.join(out, ckpt.EMA))
    print(f"wrote {out} (weights {['%.3f' % w for w in weights]})")
    return out


if __name__ == "__main__":
    main()
