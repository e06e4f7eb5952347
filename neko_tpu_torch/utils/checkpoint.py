"""Checkpoints (counterpart of neko_tpu/utils/checkpoint.py), in the port's
own format.

    <save_dir>/<exp_name>/args.json            the run's TrainingArgs, once
    <save_dir>/<exp_name>/checkpoint_<N>/
        model.pt       the model's state_dict (fp32 master weights)
        config.json    the ModelConfig fields
        train_state.pt {"step", "seed", "optimizer": the optimizer's
                       state_dict: torch AdamW's, or FusedAdamW's moments
                       and count; under gradient accumulation also
                       "mini_step" and "accum", the running mean of the
                       window's gradients}
        ema.pt         the EMA shadow (ema_decay > 0), keyed and laid out
                       as model.pt, fp32
    <save_dir>/<exp_name>/host_state_<N>_p0.pkl  the host sampler state
                                                 (utils/host_state.py)

`model.pt` + `config.json` are what `convert.load_model_dir` and
`python -m neko_tpu_torch.cli.serve --model_path` read, so a checkpoint
directory serves as it is; `--use_ema` reads `ema.pt` in its place.  A
checkpoint without `ema.pt` or "accum" (one written before the port had
EMA and accumulation, or by a run without them) restores into a state
without them, as the JAX package's pre-EMA layout does.

Over ranks the files are canonical, whatever the mesh that wrote them:
every rank joins the gather of the parameters, moments, EMA and
accumulator from every rank's blocks, the 'seq' peers' copies and the
pipeline stages' layers (`TrainContext.gather_named`), rank 0 writes the
directory, and
every rank writes its own `host_state_<N>_p<rank>.pkl` (the Trainer).  A
restore shards the canonical tensors onto the mesh of the context that
loads them, one process included.
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
EMA = "ema.pt"
NO_EMA = "checkpoint has no EMA shadow (train with --ema_decay > 0)"


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


def _canonical_trained(ctx) -> list:
    """The canonical names of the trained parameters, in one process's
    optimizer order."""
    from neko_tpu_torch.convert import model_shapes
    from neko_tpu_torch.training.train_state import lora_frozen

    return [k for k in model_shapes(ctx.model_cfg)
            if not (ctx.opt_cfg.lora_only and lora_frozen(k))]


def _per_parameter(sd: dict, names: list) -> dict:
    """{parameter name: its entry} of an optimizer state dict whose int keys
    index `names`."""
    return {names[k]: v for k, v in sd["state"].items() if isinstance(k, int)}


def _with_entries(sd: dict, entries: list) -> dict:
    """An optimizer state dict holding `entries` (one per parameter, in
    order; None: no state yet) and `sd`'s other keys and groups."""
    state = {k: v for k, v in sd["state"].items() if not isinstance(k, int)}
    state.update({i: e for i, e in enumerate(entries) if e is not None})
    groups = [dict(g, params=list(range(len(entries)))) for g in sd["param_groups"]]
    return {"param_groups": groups, "state": state}


def canonical_optimizer(ctx, state) -> dict:
    """The optimizer state dict of one process from this rank's (a
    collective over ranks): each moment gathered from every rank's blocks
    and every stage's layers, the per-parameter scalars (a count, the same
    for every parameter) kept."""
    sd = state.optimizer.state_dict()
    local = _per_parameter(sd, list(ctx.trained_parameters(state.model)))
    if not local:
        return _with_entries(sd, [None] * len(_canonical_trained(ctx)))
    template = next(iter(local.values()))
    moments = {}
    for f in sorted(template):
        if torch.is_tensor(template[f]) and template[f].dim() > 0:
            moments[f] = ctx.gather_named({n: e[f] for n, e in local.items()})
    entries = []
    for name in _canonical_trained(ctx):
        e = {f: (moments[f][name] if f in moments else v) for f, v in template.items()}
        entries.append(e)
    return _with_entries(sd, entries)


def local_optimizer(ctx, state, sd: dict) -> dict:
    """The inverse: this rank's optimizer state dict from a canonical one
    (each moment its block of this rank's parameters)."""
    canon = _per_parameter(sd, _canonical_trained(ctx))
    entries = []
    for name in ctx.trained_parameters(state.model):
        e = canon.get(ctx.canonical_name(name))
        if e is not None:
            e = {f: (ctx.shard(name, v) if torch.is_tensor(v) and v.dim() > 0 else v)
                 for f, v in e.items()}
        entries.append(e)
    return _with_entries(sd, entries)


def canonical_tensors(ctx, state):
    """(weights, optimizer state dict, EMA or None, accumulator or None),
    canonical: over ranks gathered from every rank's blocks and stages (a
    collective), in one process the live state."""
    model = state.model
    if ctx is None or not ctx.on_ranks:
        return (model.state_dict(), state.optimizer.state_dict(), state.ema, state.accum)
    weights = ctx.gather_named({n: p.detach() for n, p in model.named_parameters()})
    opt = canonical_optimizer(ctx, state)
    ema = None if state.ema is None else ctx.gather_named(state.ema)
    accum = None if state.accum is None else ctx.gather_named(state.accum)
    return weights, opt, ema, accum


def save_checkpoint(exp_dir: str, state, step: int, args: Any = None, ctx=None) -> str:
    """Write <exp_dir>/checkpoint_<step>/ from a TrainState and return its
    path.  The files go to a temporary directory that is renamed into
    place, so a crash mid-write leaves no half checkpoint.  With a `ctx`
    over ranks every rank must call this (the gather); rank 0 writes."""
    from neko_tpu_torch.parallel.multihost import process_index

    weights, opt, ema, accum = canonical_tensors(ctx, state)
    path = os.path.join(os.path.abspath(exp_dir), f"checkpoint_{step}")
    if process_index() != 0:
        return path
    if args is not None:
        save_args(exp_dir, args)
    tmp = path + ".tmp"
    save_model_dir(tmp, state.model.cfg, weights)
    ts = {"step": int(state.step), "seed": int(state.seed), "optimizer": opt}
    if accum is not None:
        ts["mini_step"] = int(state.mini_step)
        ts["accum"] = {k: v.detach().cpu() for k, v in accum.items()}
    torch.save(ts, os.path.join(tmp, TRAIN_STATE))
    if ema is not None:
        torch.save({k: v.detach().cpu() for k, v in ema.items()}, os.path.join(tmp, EMA))
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


def load_ema_params(path: str, cfg: ModelConfig, ignore=()) -> Dict[str, torch.Tensor]:
    """The EMA shadow of a checkpoint, keyed as its weights (`--use_ema`);
    raises the JAX package's error when it has none."""
    _checked_config(path, cfg, ignore)
    f = os.path.join(path, EMA)
    if not os.path.isfile(f):
        raise ValueError(f"{NO_EMA}: {path}")
    return torch.load(f, map_location="cpu", weights_only=True)


def load_checkpoint(path: str, ctx):
    """The full TrainState of a checkpoint: weights, optimizer state, step,
    and the EMA shadow and accumulator when `ctx` keeps them, on `ctx`'s
    device (`ctx` a TrainContext of the same model configuration and
    optimizer route; over ranks, each rank's blocks).  A run with EMA
    cannot restore a checkpoint without one; a checkpoint without an
    accumulator starts a fresh window."""
    sd = load_params_only(path, ctx.model_cfg)
    ts = torch.load(os.path.join(path, TRAIN_STATE), map_location="cpu", weights_only=True)
    state = ctx.init_state(sd)
    state.optimizer.load_state_dict(local_optimizer(ctx, state, ts["optimizer"]))
    state.step = int(ts["step"])
    if state.ema is not None:
        for k, v in ctx.shard_named(load_ema_params(path, ctx.model_cfg)).items():
            state.ema[k].copy_(v)
    if state.accum is not None and "accum" in ts:
        for k, v in ctx.shard_named(ts["accum"]).items():
            state.accum[k].copy_(v)
        state.mini_step = int(ts["mini_step"])
    return state
