"""Checkpoints (counterpart of neko_tpu/utils/checkpoint.py), in the port's
own format.

    <save_dir>/<exp_name>/args.json            the run's TrainingArgs, once
    <save_dir>/<exp_name>/checkpoint_<N>/
        model.pt       the model's state_dict (fp32 master weights)
        config.json    the ModelConfig fields
        train_state.pt {"step", "seed", "optimizer": the optimizer's
                       state_dict: torch AdamW's, or FusedAdamW's moments
                       and count}
    <save_dir>/<exp_name>/host_state_<N>_p0.pkl  the host sampler state
                                                 (utils/host_state.py)

`model.pt` + `config.json` are what `convert.load_model_dir` and
`python -m neko_tpu_torch.cli.serve --model_path` read, so a checkpoint
directory serves as it is.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Optional

import torch

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.convert import save_model_dir

TRAIN_STATE = "train_state.pt"


def save_args(exp_dir: str, args: Any) -> None:
    """Write args.json once (the first checkpoint of an experiment)."""
    os.makedirs(exp_dir, exist_ok=True)
    path = os.path.join(exp_dir, "args.json")
    if os.path.exists(path):
        return
    d = dataclasses.asdict(args) if dataclasses.is_dataclass(args) else dict(args)
    with open(path, "w") as fh:
        json.dump(d, fh, indent=2)


def load_args_dict(exp_dir_or_file: str) -> dict:
    path = exp_dir_or_file
    if os.path.isdir(path):
        path = os.path.join(path, "args.json")
    with open(path) as fh:
        return json.load(fh)


def save_checkpoint(exp_dir: str, state, step: int, args: Any = None) -> str:
    """Write <exp_dir>/checkpoint_<step>/ from a TrainState and return its
    path.  The files go to a temporary directory that is renamed into
    place, so a crash mid-write leaves no half checkpoint."""
    if args is not None:
        save_args(exp_dir, args)
    path = os.path.join(os.path.abspath(exp_dir), f"checkpoint_{step}")
    tmp = path + ".tmp"
    model = state.model
    save_model_dir(tmp, model.cfg, model.state_dict())
    torch.save({"step": int(state.step), "seed": int(state.seed),
                "optimizer": state.optimizer.state_dict()},
               os.path.join(tmp, TRAIN_STATE))
    if os.path.isdir(path):  # a re-save of the same step replaces it
        for name in os.listdir(path):
            os.remove(os.path.join(path, name))
        os.rmdir(path)
    os.replace(tmp, path)
    return path


def latest_checkpoint(exp_dir: str) -> Optional[str]:
    if not os.path.isdir(exp_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(exp_dir)
             if (m := re.fullmatch(r"checkpoint_(\d+)", name))]
    if not steps:
        return None
    return os.path.join(exp_dir, f"checkpoint_{max(steps)}")


def resolve_checkpoint_dir(model_path: str) -> str:
    """`model_path` may be a checkpoint_<N> dir or an experiment dir (its
    latest checkpoint is used)."""
    if os.path.isdir(model_path) and not os.path.basename(
            os.path.normpath(model_path)).startswith("checkpoint_"):
        found = latest_checkpoint(model_path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint_* under {model_path}")
        return found
    return model_path


def saved_model_config(path: str) -> ModelConfig:
    """The ModelConfig a checkpoint dir was written with."""
    with open(os.path.join(path, "config.json")) as f:
        return ModelConfig.from_dict(json.load(f))


def _checked_config(path: str, cfg: ModelConfig, ignore=()) -> None:
    saved = saved_model_config(path)
    diff = {k: (getattr(saved, k), getattr(cfg, k)) for k in dataclasses.asdict(cfg)
            if k not in ignore and getattr(saved, k) != getattr(cfg, k)}
    if diff:
        raise ValueError(f"{path} holds another model configuration (saved, run): {diff}")


def load_params_only(path: str, cfg: ModelConfig, ignore=()) -> Dict[str, torch.Tensor]:
    """The weights of a checkpoint (a warm start: `--init_checkpoint`; an
    inference restore).  `cfg` must equal the saved configuration but for
    the fields in `ignore`."""
    _checked_config(path, cfg, ignore)
    return torch.load(os.path.join(path, "model.pt"), map_location="cpu", weights_only=True)


def load_checkpoint(path: str, ctx):
    """The full TrainState of a checkpoint: weights, optimizer state and
    step, on `ctx`'s device (`ctx` a TrainContext of the same model
    configuration and optimizer route)."""
    sd = load_params_only(path, ctx.model_cfg)
    ts = torch.load(os.path.join(path, TRAIN_STATE), map_location="cpu", weights_only=True)
    state = ctx.init_state(sd)
    state.optimizer.load_state_dict(ts["optimizer"])
    state.step = int(ts["step"])
    return state
