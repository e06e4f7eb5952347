"""Which dims of which parameters a rank holds (counterpart of
neko_tpu/parallel/sharding.py), and the moves between the canonical state
dict and a rank's shards.

Tensor parallelism ('model').  neko_tpu's rule table, under the port's
state-dict names and torch's layouts (a Linear weight is the transposed
flax kernel):

* attention c_attn, MLP c_fc and GEGLU gate: the OUTPUT dim (weight dim 0,
  and the bias) split over 'model': each rank holds its heads and its block
  of the MLP width (column-parallel);
* attention and MLP c_proj: the INPUT dim (weight dim 1) split; their
  biases replicated (row-parallel: one all-reduce a block, added after it);
* embed_token and the head predict_token: the vocabulary dim (dim 0 of
  both) split in contiguous blocks;
* everything else replicated.

fp8 serving (inference/quant.py): a quantized weight shards as its weight;
its scales (`<m>.qscale`, one a output row) split with the output dim of a
column-parallel layer (c_attn by heads as its rows, c_fc, gate,
predict_token) and stay whole for a row-parallel one (c_proj), neko_tpu's
`quant_pspec`.  The canonical weights are quantized before they are split.

One departure of layout, not of arithmetic: the fused c_attn computes
q | k | v from one [3D, D] weight.  neko_tpu splits its output dim in
contiguous blocks and GSPMD relays the columns afterwards; here rank r
holds the q, k and v rows of its own heads, [q_r | k_r | v_r], so its
attention reads [B, S, 3D / m] with H / m heads and nothing moves.  LoRA's
`lora_b` (the rows of q, k, v as well, which neko_tpu keeps replicated)
takes the same split, so that its output adds to this rank's columns.  The
canonical state dict (checkpoints, the evaluation replica) keeps the
one-process layout.

Every leaf is replicated over 'seq' (its gradient summed there as over
'data'); over 'pipe' a rank holds its stage's layers and a copy of the
root leaves (parallel/pipeline.py), each split as above.

FSDP ('data', `fsdp=True`): a leaf of at least `FSDP_MIN_SIZE` elements
also splits over 'data', along its largest dim that 'model' leaves alone and
that the 'data' size divides (neko_tpu's `fsdp_param_pspec`, ties resolved
in the flax dim order as there).  The optimizer's moments, the EMA and the
accumulator follow their parameter.

* `layout(cfg, mesh, fsdp)`: {key: LeafSpec(model_dim, data_dim)}.
* `shard_tensor` / `gather_tensor`, `shard_state_dict`: canonical -> this
  rank's block, and back (the gather is a collective of every rank;
  `TrainContext.gather_named` gathers a state dict, its stages too).
* `fsdp_gathers(module, prefix, layout, axis)`: the use-site all-gathers of
  one FSDP unit (a Block, or the root's leaves outside the blocks), for
  `torch.func.functional_call`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from neko_tpu_torch.parallel.collectives import LOCAL, Axis, all_gather_cat, gather_shard

# (suffix of the state-dict key, the torch dim split over 'model'); first hit
# wins.  neko_tpu/parallel/sharding.py's _RULES, in torch layouts.
_RULES = (
    ("embed_token.weight", 0),      # ("embed_token", "embedding")  P("model", None)
    ("predict_token.weight", 0),    # ("predict_token", "kernel")   P(None, "model")
    ("attn.c_attn.weight", 0),      # ("attn", "c_attn", "kernel")  P(None, "model")
    ("attn.c_attn.bias", 0),        # P("model")
    ("attn.lora_b.weight", 0),      # the port's: follows c_attn's heads
    ("attn.c_proj.weight", 1),      # ("attn", "c_proj", "kernel")  P("model", None)
    ("attn.c_proj.bias", None),
    ("mlp.c_fc.weight", 0),
    ("mlp.c_fc.bias", 0),
    ("mlp.gate.weight", 0),
    ("mlp.gate.bias", 0),
    ("mlp.c_proj.weight", 1),
    ("mlp.c_proj.bias", None),
)
# the leaves whose dim 0 is q | k | v (each rank takes its heads of each)
_QKV = ("attn.c_attn.weight", "attn.c_attn.bias", "attn.lora_b.weight")

# --fsdp: minimum leaf size (elements) worth sharding over 'data' (neko_tpu's)
FSDP_MIN_SIZE = 1 << 16


class LeafSpec(NamedTuple):
    model_dim: Optional[int]  # torch dim split over 'model' (its rule, whatever the size)
    data_dim: Optional[int]   # torch dim split over 'data' (fsdp), or None


def model_dim(key: str) -> Optional[int]:
    if key.endswith(".qscale"):  # fp8 serving: a weight's per-output-channel scales
        dim = model_dim(key[:-len("qscale")] + "weight")
        return 0 if dim == 0 else None  # along a column-parallel output, else whole
    for suffix, dim in _RULES:
        if key == suffix or key.endswith("." + suffix):
            return dim
    return None


def fsdp_dim(key: str, shape, data: int) -> Optional[int]:
    """neko_tpu's `fsdp_param_pspec` choice in torch dims: the largest dim
    that is not the 'model' dim and that `data` divides, the first in the
    flax dim order on a tie; None under FSDP_MIN_SIZE or with data 1."""
    from neko_tpu_torch.convert import jax_leaf

    size = 1
    for s in shape:
        size *= int(s)
    if data <= 1 or len(shape) == 0 or size < FSDP_MIN_SIZE:
        return None
    tp = model_dim(key)
    _, flax_order = jax_leaf(key, len(shape))
    cand = [d for d in flax_order if d != tp and shape[d] % data == 0]
    if not cand:
        return None
    return max(cand, key=lambda d: shape[d])  # max keeps the first of equals


def layout(shapes: Dict[str, torch.Size], model: int = 1, data: int = 1,
           fsdp: bool = False) -> Dict[str, LeafSpec]:
    """{key: LeafSpec} of a state dict's shapes on a grid of `data` x
    `model` ranks; raises when a 'model' dim does not split."""
    out = {}
    for key, shape in shapes.items():
        md = model_dim(key)
        if model > 1 and md is not None and shape[md] % model:
            raise ValueError(f"{key}: dim {md} of {tuple(shape)} does not split over "
                             f"model={model}")
        dd = fsdp_dim(key, shape, data) if fsdp else None
        out[key] = LeafSpec(md, dd)
    return out


def model_layout(cfg, mesh, fsdp: bool = False) -> Dict[str, LeafSpec]:
    """`layout` of NekoModel(cfg)'s parameters on `mesh` (None: one
    process); on a 'pipe' mesh of a stage's parameters, under their local
    names (parallel/pipeline.py)."""
    from neko_tpu_torch.convert import stage_shapes

    if mesh is None:
        return layout(stage_shapes(cfg, None))
    shape = mesh.shape
    if shape["model"] > 1 and cfg.heads % shape["model"]:
        raise ValueError(f"heads={cfg.heads} do not split over model={shape['model']}")
    return layout(stage_shapes(cfg, mesh), shape["model"], shape["data"], fsdp)


def _axes(mesh):
    if mesh is None:
        return LOCAL, LOCAL
    return mesh.axis("model"), mesh.axis("data")


def _qkv(key: str) -> bool:
    if key.endswith(".qscale"):
        key = key[:-len("qscale")] + "weight"
    return any(key == s or key.endswith("." + s) for s in _QKV)


def _model_block(t: torch.Tensor, key: str, dim: int, ax: Axis) -> torch.Tensor:
    if _qkv(key):  # [q | k | v] along dim 0: this rank's block of each
        return torch.cat([part.chunk(ax.size, 0)[ax.index] for part in t.chunk(3, 0)])
    return t.chunk(ax.size, dim)[ax.index]


def shard_tensor(t: torch.Tensor, key: str, spec: LeafSpec, mesh) -> torch.Tensor:
    """This rank's block of the canonical tensor `t` (a copy)."""
    tp, dp = _axes(mesh)
    if tp.on and spec.model_dim is not None:
        t = _model_block(t, key, spec.model_dim, tp)
    if dp.on and spec.data_dim is not None:
        t = t.chunk(dp.size, spec.data_dim)[dp.index]
    return t.contiguous().clone()


def gather_tensor(t: torch.Tensor, key: str, spec: LeafSpec, mesh) -> torch.Tensor:
    """The canonical tensor from every rank's block (a collective)."""
    tp, dp = _axes(mesh)
    if dp.on and spec.data_dim is not None:
        t = all_gather_cat(t, spec.data_dim, dp)
    if tp.on and spec.model_dim is not None:
        full = all_gather_cat(t, spec.model_dim, tp)
        if _qkv(key):  # blocks [q_r | k_r | v_r] -> [q | k | v]
            blocks = [b.chunk(3, 0) for b in full.chunk(tp.size, 0)]
            full = torch.cat([blocks[r][part] for part in range(3) for r in range(tp.size)])
        t = full
    return t


def local_shape(shape, spec: LeafSpec, mesh) -> tuple:
    tp, dp = _axes(mesh)
    out = list(shape)
    if tp.on and spec.model_dim is not None:
        out[spec.model_dim] //= tp.size
    if dp.on and spec.data_dim is not None:
        out[spec.data_dim] //= dp.size
    return tuple(out)


def shard_state_dict(sd: Dict[str, torch.Tensor], specs: Dict[str, LeafSpec],
                     mesh) -> Dict[str, torch.Tensor]:
    return {k: shard_tensor(v, k, specs[k], mesh) for k, v in sd.items()}


def fsdp_gathers(module: torch.nn.Module, prefix: str, specs: Dict[str, LeafSpec],
                 axis: Axis, skip: str = None):
    """-> a function returning {name: gathered tensor} for the leaves of
    `module` (named relative to it; its state-dict prefix is `prefix`) that
    are split over 'data', leaving out the submodule `skip`.  Each call
    gathers anew: the forward's use-site all-gather, its gradient the
    reduce-scatter."""
    entries = [(name, p, specs[prefix + name].data_dim)
               for name, p in module.named_parameters()
               if specs[prefix + name].data_dim is not None
               and not (skip and name.startswith(skip + "."))]

    def gathered():
        return {name: gather_shard(p, dim, axis) for name, p, dim in entries}

    gathered.count = len(entries)
    return gathered


def enable_fsdp(model, specs: Dict[str, LeafSpec], axis: Axis) -> None:
    """Give `model` (a NekoModel of this rank) its FSDP units: each Block,
    and the root's leaves outside the blocks, gather their 'data'-split
    leaves at use (models/transformer.py `call_block`, models/policy.py).
    Nothing when no leaf is split over 'data'."""
    root = fsdp_gathers(model, "", specs, axis, skip="transformer.h")
    model.fsdp_gather = root if root.count else None
    for i, block in enumerate(model.transformer.h):
        g = fsdp_gathers(block, f"transformer.h.{i}.", specs, axis)
        block.fsdp_gather = g if g.count else None
