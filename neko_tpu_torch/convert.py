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
`padded_vocab_size`).  Pure numpy <-> torch: no JAX needed here.  Sequence
parallelism adds no parameter (the ring has none): `TrainContext(mesh=...)`
takes the same converted state dict.

LoRA's `lora_a` / `lora_b` and GEGLU's `gate` map by the same rule (lora_b's
[r, 3D] SplitProj kernel is the [3D, r] Linear weight), and
`jax_train_extras_to_torch` carries neko_tpu's EMA shadow and
`optax.MultiSteps` accumulator.  On a 'pipe' mesh neko_tpu stores the
layers stacked, transformer/h_stack [n_stages, Lp, ...];
`jax_stacked_params_to_stage_state_dicts` / `stage_state_dicts_to_jax_stacked`
map that tree to the port's per-stage state dicts (parallel/pipeline.py)
and back.

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
from neko_tpu_torch.ops.quant import SCALE

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


def _unstack_tree(params_np: Dict) -> Dict:
    """neko_tpu's stacked transformer/h_stack [n_stages, Lp, ...] -> the
    per-layer h_i subtrees (a copy of the dict levels; leaves shared)."""
    tree = dict(params_np)
    tr = dict(tree["transformer"])
    stack = tr.pop("h_stack")
    flat = {path: np.asarray(a) for path, a in _flatten(stack).items()}
    n, lp = next(iter(flat.values())).shape[:2]
    for i in range(n * lp):
        layer: Dict = {}
        for path, a in flat.items():
            node = layer
            *mods, leaf = path.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = a[i // lp, i % lp]
        tr[f"h_{i}"] = layer
    tree["transformer"] = tr
    return tree


def jax_stacked_params_to_stage_state_dicts(params_np: Dict, cfg: ModelConfig):
    """neko_tpu's stage-local params (h_stack [n_stages, Lp, ...]) -> the
    port's state dict of each stage (parallel/pipeline.py)."""
    from neko_tpu_torch.parallel import pipeline

    n = np.asarray(next(iter(_flatten(params_np["transformer"]["h_stack"]).values()))).shape[0]
    sd = jax_params_to_state_dict(_unstack_tree(params_np), cfg)
    return [pipeline.stage_state_dict(sd, cfg.layers, n, p) for p in range(n)]


def stage_state_dicts_to_jax_stacked(stage_sds, cfg: ModelConfig) -> Dict:
    """The inverse: every stage's state dict -> neko_tpu's stage-local tree
    (numpy), transformer/h_stack [n_stages, Lp, ...]."""
    from neko_tpu_torch.parallel import pipeline

    n, lp = len(stage_sds), cfg.layers // len(stage_sds)
    tree = state_dict_to_jax_params(pipeline.canonical_state_dict(stage_sds, cfg), cfg)
    tr = tree["transformer"]
    layers = [_flatten(tr.pop(f"h_{i}")) for i in range(cfg.layers)]
    stack: Dict = {}
    for path in layers[0]:
        node = stack
        *mods, leaf = path.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.stack([layer[path] for layer in layers]).reshape(
            n, lp, *layers[0][path].shape)
    tr["h_stack"] = stack
    return tree


def jax_fused_adamw_state_to_torch(opt_state, cfg: ModelConfig) -> Dict:
    """neko_tpu's `FusedAdamWState` (count, per-leaf mu and nu trees; jax or
    numpy arrays) -> {"count": int, "mu": ..., "nu": ...} with the moments
    keyed and laid out as the state dict (the params mapping, leaf for leaf),
    as `TrainContext.init_state(fused_adamw_state=...)` takes it."""
    return {"count": int(np.asarray(opt_state.count)),
            "mu": jax_params_to_state_dict(opt_state.mu, cfg),
            "nu": jax_params_to_state_dict(opt_state.nu, cfg)}


def torch_fused_adamw_state_to_jax(state: Dict, cfg: ModelConfig) -> Dict:
    """The inverse of `jax_fused_adamw_state_to_torch`: -> {"count": int32,
    "mu": tree, "nu": tree} of numpy arrays, the fields of neko_tpu's
    `FusedAdamWState`."""
    return {"count": np.int32(state["count"]),
            "mu": state_dict_to_jax_params(state["mu"], cfg),
            "nu": state_dict_to_jax_params(state["nu"], cfg)}


def jax_train_extras_to_torch(ema_params, opt_state, cfg: ModelConfig) -> Dict:
    """neko_tpu's EMA shadow (`TrainState.ema_params`, or None) and, when
    `opt_state` is an `optax.MultiStepsState` (gradient accumulation), its
    accumulator and mini-step -> {"ema", "accum", "mini_step"} keyed and laid
    out as the state dict: what the port's `TrainState.ema` / `accum` /
    `mini_step` hold (None where the JAX state has none)."""
    acc = getattr(opt_state, "acc_grads", None)
    return {"ema": None if ema_params is None else jax_params_to_state_dict(ema_params, cfg),
            "accum": None if acc is None else jax_params_to_state_dict(acc, cfg),
            "mini_step": int(np.asarray(getattr(opt_state, "mini_step", 0)))}


def jax_vq_variables_to_state_dict(params: Dict, codebook: Dict) -> Dict[str, torch.Tensor]:
    """neko_tpu's VQ-VAE variables as numpy trees (`params`: encoder/Conv_0..3,
    decoder/Conv_0, ConvTranspose_0, ConvTranspose_1, Conv_1, each {kernel
    HWIO, bias}; `codebook`: {embedding, cluster_size, cluster_sum}) -> the
    state dict of `models/vq.VQVAE`.  A Conv kernel becomes OIHW; a
    ConvTranspose kernel is flipped in both spatial axes and laid out
    [in, out, kh, kw] (models/vq.py `SameConvTranspose`)."""
    sd = {}
    for path, leaf in _flatten(params).items():
        key = path.replace("/", ".")
        if path.endswith("/kernel"):
            key = key[: -len("kernel")] + "weight"
            leaf = (leaf[::-1, ::-1].transpose(2, 3, 0, 1) if "/ConvTranspose_" in path
                    else leaf.transpose(3, 2, 0, 1))
        sd[key] = torch.from_numpy(np.array(leaf, np.float32, order="C"))
    for name in ("embedding", "cluster_size", "cluster_sum"):
        sd[name] = torch.from_numpy(np.array(codebook[name], np.float32, order="C"))
    return sd


_NORMS = ("ln_1", "ln_2", "ln_f", "gn2")
_EMBEDS = ("embed_token", "pos_embed_observation", "height", "width")


def jax_leaf(key: str, ndim: int):
    """(flax path, torch dim of each flax dim) of the state-dict entry `key`
    of rank `ndim`: a Dense kernel is the transposed Linear weight, a Conv
    kernel HWIO the OIHW weight; every other leaf keeps its dims."""
    *mods, leaf = key.split(".")
    path = []
    for m in mods:
        if m.isdigit():
            path[-1] = f"h_{m}"
        else:
            path.append(m)
    name = path[-1]
    if leaf == "bias":
        return tuple(path) + ("bias",), tuple(range(ndim))
    if ndim == 4:
        return tuple(path) + ("kernel",), (2, 3, 1, 0)
    if name in _NORMS:
        return tuple(path) + ("scale",), tuple(range(ndim))
    if name in _EMBEDS:
        return tuple(path) + ("embedding",), tuple(range(ndim))
    return tuple(path) + ("kernel",), tuple(reversed(range(ndim)))


def state_dict_to_jax_params(sd: Dict[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """NekoModel state_dict -> flax params (nested dict of numpy arrays),
    the inverse of `jax_params_to_state_dict`."""
    _check_against_model(sd, cfg)
    tree: Dict = {}
    for key, t in sd.items():
        a = t.detach().cpu().numpy()
        path, dims = jax_leaf(key, a.ndim)
        node = tree
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = np.ascontiguousarray(a.transpose(dims))
    return tree


def model_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    from neko_tpu_torch.models.policy import NekoModel

    with torch.device("meta"):
        model = NekoModel(cfg)
    return {k: v.shape for k, v in model.state_dict().items()}


def stage_shapes(cfg: ModelConfig, mesh) -> Dict[str, torch.Size]:
    """`model_shapes` of a rank's model on `mesh`: on a 'pipe' mesh its
    stage's leaves under their local names (parallel/pipeline.py), else
    all of them."""
    from neko_tpu_torch.parallel import pipeline

    shapes = model_shapes(cfg)
    n = pipeline.pipe_axis_size(mesh)
    if n == 1:
        return shapes
    return pipeline.stage_state_dict(shapes, cfg.layers, n, mesh.axis("pipe").index)


def _check_against_model(sd: Dict[str, torch.Tensor], cfg: ModelConfig, mesh=None) -> None:
    want = stage_shapes(cfg, mesh)
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
    kernels and embeddings, zero biases, unit norm scales; LoRA's `lora_a`
    he-uniform (bound sqrt(6 / D)) and `lora_b` zero, so the adapter starts
    as the identity; fp32 (the param dtype), drawn from numpy's generator
    seeded with `seed`."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in model_shapes(cfg).items():
        mod, leaf = key.rsplit(".", 2)[-2:]
        if leaf == "bias" or mod == "lora_b":
            a = np.zeros(shape, np.float32)
        elif mod in _NORMS:
            a = np.ones(shape, np.float32)
        elif mod == "lora_a":
            bound = np.sqrt(6.0 / shape[1])
            a = rng.uniform(-bound, bound, tuple(shape)).astype(np.float32)
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


def build_model(cfg: ModelConfig, state_dict: Dict[str, torch.Tensor], device="cuda",
                mesh=None, specs=None):
    """NekoModel on `device` (the card unless the caller asks for the CPU)
    holding `state_dict` (built on the meta device first, so no throwaway
    random init runs).  With a `mesh` over ranks the model is this rank's:
    `state_dict` is canonical and each parameter takes its block of it
    (`specs`: parallel/sharding.py's layout, by default the mesh's
    tensor-parallel one); leaves split over 'data' (fsdp) are gathered at
    their use.  On a 'pipe' mesh the model holds the rank's stage of the
    canonical `state_dict`.  A state dict quantized for fp8 serving
    (inference/quant.py `quantize_state_dict`) gives a model whose quantized
    Linears hold its fp8 weights and `qscale` buffers, split as
    parallel/sharding.py lays them out."""
    from neko_tpu_torch.models.policy import NekoModel
    from neko_tpu_torch.parallel import pipeline, sharding

    state_dict, scales = _split_scales(state_dict)
    n_stages = pipeline.pipe_axis_size(mesh)
    if n_stages > 1:
        _check_against_model(state_dict, cfg)
        state_dict = pipeline.stage_state_dict(state_dict, cfg.layers, n_stages,
                                               mesh.axis("pipe").index)
    _check_against_model(state_dict, cfg, mesh)
    if mesh is None or not mesh.on_ranks:
        with torch.device("meta"):
            model = NekoModel(cfg)
        model.load_state_dict(state_dict, assign=True)
        _add_scales(model, scales, None)
        return model.to(device).eval()
    specs = specs or sharding.model_layout(cfg, mesh)
    with torch.device("meta"):
        model = NekoModel(cfg, mesh)
    for key, t in sharding.shard_state_dict(state_dict, specs, mesh).items():
        mod, _, leaf = key.rpartition(".")
        setattr(model.get_submodule(mod), leaf, torch.nn.Parameter(t))
    _add_scales(model, scales, mesh)
    model = model.to(device).eval()
    sharding.enable_fsdp(model, specs, mesh.axis("data"))
    return model


def assign_state(model, state_dict: Dict[str, torch.Tensor]) -> None:
    """Take `state_dict` (the model's own keys and shapes; quantized for
    fp8 serving or not) into `model` in place, each tensor as it is: its
    dtype, its device.  A quantized entry's Linear takes the fp8 weight and
    its `qscale` buffer."""
    state_dict, scales = _split_scales(state_dict)
    model.load_state_dict(state_dict, assign=True)
    _add_scales(model, scales, None)


def _split_scales(state_dict):
    """-> (the state dict without its quantized weights' scales, the scales)."""
    scales = {k: v for k, v in state_dict.items() if k.endswith("." + SCALE)}
    return {k: v for k, v in state_dict.items() if k not in scales}, scales


def _add_scales(model, scales: Dict[str, torch.Tensor], mesh) -> None:
    """The `qscale` buffers of a quantized state dict (this rank's block of
    each over 'model' for a canonical one on a `mesh`); their fp8 weights
    take no gradient."""
    from neko_tpu_torch.parallel import sharding

    for key, s in scales.items():
        mod = model.get_submodule(key.rpartition(".")[0])
        if mesh is not None:
            s = sharding.shard_tensor(s, key, sharding.LeafSpec(sharding.model_dim(key), None),
                                      mesh)
        mod.register_buffer(SCALE, s)
        mod.weight.requires_grad_(False)


def read_model_dir(path: str):
    """-> (ModelConfig, the saved state dict on the CPU)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                    weights_only=True)
    return cfg, sd


def load_model_dir(path: str, device="cuda"):
    """-> (ModelConfig, NekoModel on `device` (the card unless the caller
    asks for the CPU) with the saved weights)."""
    cfg, sd = read_model_dir(path)
    return cfg, build_model(cfg, sd, device)
