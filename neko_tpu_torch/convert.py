"""Weights between the JAX package's flax tree and this package's modules.

The torch submodules carry the flax names, so a flax path maps to a
state_dict key by rule:

    transformer/h_3/attn/c_attn/kernel  ->  transformer.h.3.attn.c_attn.weight

and each leaf by kind:

    Dense kernel [in, out]          -> Linear weight [out, in] (transposed)
    Conv kernel  [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw] (HWIO -> OIHW)
    Embed embedding, norm scale     -> weight (as is)
    bias                            -> bias (as is)

Embedding rows and head columns stay padded 1:1 (`padded_embed_rows`,
`padded_vocab_size`).  Pure numpy <-> torch: no JAX needed here.

A served model lives in a directory holding `model.pt` (the state_dict) and
`config.json` (the ModelConfig fields); `save_model_dir` / `load_model_dir`
write and read it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict

import numpy as np
import torch

from neko_tpu_torch.config import ModelConfig

_INIT_STD = 0.02  # the JAX package's _INIT: normal(stddev=0.02)


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _torch_key(path: str) -> str:
    *mods, leaf = path.split("/")
    mods = [re.sub(r"^h_(\d+)$", r"h.\1", m) for m in mods]
    return ".".join(mods + ["bias" if leaf == "bias" else "weight"])


def jax_params_to_state_dict(params_np: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax params (nested dict of arrays) -> NekoModel state_dict."""
    sd = {}
    for path, a in _flatten(params_np).items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel" and a.ndim == 2:
            a = a.T
        elif leaf == "kernel" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif leaf not in ("kernel", "bias", "scale", "embedding"):
            raise ValueError(f"unexpected flax leaf {path!r}")
        sd[_torch_key(path)] = torch.tensor(a)  # copies (flax leaves are read-only)
    _check_against_model(sd, cfg)
    return sd


def jax_grads_to_state_dict(grads_np: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Gradients of the flax params (same tree) -> state_dict-keyed
    gradients: the params mapping, leaf for leaf."""
    return jax_params_to_state_dict(grads_np, cfg)


def state_dict_to_jax_params(sd: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """NekoModel state_dict -> flax params (nested dict of numpy arrays),
    the inverse of `jax_params_to_state_dict`."""
    _check_against_model(sd, cfg)
    tree: Dict = {}
    for key, t in sd.items():
        a = t.detach().cpu().numpy()
        *mods, leaf = key.split(".")
        path = []
        for m in mods:
            if m.isdigit():
                path[-1] = f"h_{m}"
            else:
                path.append(m)
        name = path[-1]
        if leaf == "bias":
            fl = "bias"
        elif a.ndim == 4:
            fl, a = "kernel", a.transpose(2, 3, 1, 0)
        elif name in ("ln_1", "ln_2", "ln_f", "gn2"):
            fl = "scale"
        elif name in ("embed_token", "pos_embed_observation", "height", "width"):
            fl = "embedding"
        else:
            fl, a = "kernel", a.T
        node = tree
        for m in path:
            node = node.setdefault(m, {})
        node[fl] = np.ascontiguousarray(a)
    return tree


def _model_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    from neko_tpu_torch.models.policy import NekoModel

    with torch.device("meta"):
        model = NekoModel(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def _check_against_model(sd: Dict[str, torch.Tensor], cfg: ModelConfig) -> None:
    want = _model_shapes(cfg)
    missing, extra = set(want) - set(sd), set(sd) - set(want)
    if missing or extra:
        raise ValueError(
            f"parameter names differ from NekoModel({cfg.embed_dim}d/"
            f"{cfg.layers}L): missing {sorted(missing)}, unexpected {sorted(extra)}"
        )
    for k, shape in want.items():
        if sd[k].shape != shape:
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)}, model wants {tuple(shape)}")


def init_state_dict(cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights as the JAX package initializes them: N(0, 0.02) for
    kernels and embeddings, zero biases, unit norm scales; fp32 (the
    param dtype), drawn from numpy's generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    sd = {}
    norms = ("ln_1", "ln_2", "ln_f", "gn2")
    for key, shape in _model_shapes(cfg).items():
        mod, leaf = key.rsplit(".", 2)[-2:]
        if leaf == "bias":
            a = np.zeros(shape, np.float32)
        elif mod in norms:
            a = np.ones(shape, np.float32)
        else:
            a = rng.standard_normal(tuple(shape), dtype=np.float32) * np.float32(_INIT_STD)
        sd[key] = torch.from_numpy(a)
    return sd


def save_model_dir(path: str, cfg: ModelConfig, state_dict: Dict[str, torch.Tensor]) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(path, "model.pt"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)


def build_model(cfg: ModelConfig, state_dict: Dict[str, torch.Tensor], device="cuda"):
    """NekoModel on `device` (the card unless the caller asks for the CPU)
    holding `state_dict` (built on the meta device first, so no throwaway
    random init runs)."""
    from neko_tpu_torch.models.policy import NekoModel

    _check_against_model(state_dict, cfg)
    with torch.device("meta"):
        model = NekoModel(cfg)
    model.load_state_dict(state_dict, assign=True)
    return model.to(device).eval()


def load_model_dir(path: str, device="cuda"):
    """-> (ModelConfig, NekoModel on `device` (the card unless the caller
    asks for the CPU) with the saved weights)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                    weights_only=True)
    return cfg, build_model(cfg, sd, device)
