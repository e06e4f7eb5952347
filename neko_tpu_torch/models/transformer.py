"""Decoder-only transformer core (counterpart of
neko_tpu/models/transformer.py).

* pre-LN blocks: x + attn(ln_1(x)); x + mlp(ln_2(x)); no absolute position
  embedding (positions come from the structured encodings upstream).
* `mode='train'`: full causal attention over the packed context through the
  head-packed kernels (whole-head up to S = 1024, blocked above, any S, any
  hd <= 128): q, k and v stay the three column slices of the one
  [B, S, 3D] `c_attn` output (no transpose, one gradient buffer), with
  attention, residual and MLP dropout when a `generator` (the step's
  `torch.Generator`) is given.  At hd > 128, where the JAX package has no
  kernel and runs its XLA attention, the attention is the plain route of
  ops/attention.py (`wide_attention_qkv`, its dropout mask drawn from the
  generator); prefill and decode route there too, and a 'seq' axis refuses
  it by name (the JAX package's XLA ring is not ported).  Under an active
  mesh whose 'seq' axis has more than one shard (`parallel/mesh.py`) the
  attention runs as ring attention over the sequence shards instead
  (`ops/ring_kernel.py`), before the whole-head / blocked dispatch, as the
  JAX package routes it; S must split over the axis.  Each layer draws its attention seed as an
  int32 [1] tensor on the device from that generator, as the JAX package
  draws one per layer from its dropout stream.  Without a generator the
  pass is deterministic (eval loss).
* `mode='prefill'`: full causal attention through the whole-head kernel
  wrapper on [B, H, S, hd] (always: `cfg.attention_impl` is carried for
  config round trips and ignored), returning each layer's KV cache: keys and
  values [B, H, S, hd] in the activation dtype plus the bool [B, S] key mask.
  Under `kv_cache_dtype='int8'` the cache stores int8 rows with fp32 row
  scales ("key_scale", "value_scale" [B, H, S]; `quant_rows`), while the
  prefill's own attention runs on the full-precision k and v, as the JAX
  package's does.
* `mode='decode'`: one token per row written at `decode_index` (the caller
  passes `pos % context_len` for the ring), then attention of that token over
  the cached keys through the decode kernel (#14, `ops/decode_attention.py`).
  The cache tensors are updated IN PLACE: unlike the JAX package's
  functional cache, a decode step mutates the cache it is given.  The
  kernel takes the cache mask (with the new row set) and, as its range of
  work, one window [start, end) per row from the first to the last valid
  row, computed once a step; rows inside the window that the mask clears
  are skipped, so a mask with holes is attended as the JAX package attends
  it (attention over the cache does not depend on the order of its rows).
  An int8 cache takes the new row quantized and goes through #14's int8
  path (`decode_attention_int8`).
* `mode='extend'`: the rollout cache's ring append (the JAX package's
  'extend' mode with `extend_clear`).  The timestep slot
  [clear_start, clear_start + clear_len) modulo buffer_len is cleared from
  the cache mask, the K new tokens are written at (decode_index + i) %
  buffer_len and set in it, and each new token attends the cache mask minus
  the chunk tokens written after it (a suffix-OR over their one-hot
  positions).  Without `extend_clear` it is the APPEND mode of speculative
  decoding's verify rounds: the K tokens are written at decode_index + i
  (no ring, no eviction) and query i attends every column c <= decode_index
  + i, whatever the cache mask says; the mask is not maintained (right-padded
  prompts leave no hole below the write position, and each round's writes
  cover the previous round's rejected tail).  Either way the attention is
  plain torch, as the JAX package computes it in XLA outside any kernel:
  fp32 scores with a finite -1e9 fill, fp32 softmax, probabilities cast to
  the value dtype.  The caches are updated in place.  An int8 cache takes
  the chunk quantized, with its scales at the same positions, and attends
  through the plain `quant_cache_attention` (the JAX package's
  `_quant_cache_attention`, XLA there too).

Mixed precision by explicit casts, as flax does it (not torch.autocast,
whose LayerNorm returns fp32): each Linear casts its input and its fp32
weight to `cfg.dtype`; each LayerNorm normalizes in the dtype of its weight
(fp32 when training) and returns `cfg.dtype`.  Served weights are already in
the activation dtype, so there every cast is a no-op.  Attention logits and
softmax are fp32.

The MLP's activation follows `cfg.activation_fn` as the JAX package
orders it: 'gelu_new' is the tanh approximation, anything else the erf
GELU, and 'geglu' multiplies that erf GELU by a `gate` Linear of width 4D.
`cfg.lora_r > 0` adds LoRA to `c_attn` in every mode: `lora_a` (D -> r,
no bias), dropout at `lora_dropout` from the step's generator (train mode
only), `lora_b` (r -> 3D, no bias, zero at init, its three row blocks the
JAX package's SplitProj outputs), q, k and v each getting (alpha / r) times
their block before the attention kernel.

Train mode with a generator also applies stochastic depth: each residual
branch of layer i keeps or drops per example ([B, 1, 1]) at keep_p =
1 - stochastic_depth * i / max(L - 1, 1), survivors scaled by 1 / keep_p.
`cfg.remat` recomputes each block in the backward (`torch.utils.checkpoint`,
non-reentrant).  The checkpoint restores only torch's global RNGs, and every
draw here comes from the step's generator, so the block's forward runs on
the live generator and the recompute on a clone set to the live one's state
before the block: the same masks, the live generator ending the step where
it would without remat.  The recompute also re-enters the mesh that was
active in the forward (the backward may run on another thread, and
`seq_shards()` reads the thread's mesh), so it routes to the same kernel.

Tensor parallelism (a 'model' axis over ranks, `tp`; parallel/sharding.py
has the layout): c_attn, c_fc and the GEGLU gate are column-parallel (this
rank's heads, H / m of them, and its block of the MLP width, their input's
gradient summed over 'model'), both c_proj are row-parallel (the partial
products summed over 'model', then the bias), and LoRA's `lora_b` follows
c_attn's heads (parallel/collectives.py has the pair).  The
dropout masks of the replicated activations come from the step's
generator, which model peers share; the attention kernels' seed adds the
rank's per-axis offset (`seed_offset`).  The inference modes run there too:
each rank's caches hold its H / m heads, which the prefill kernel (#1) and
the decode kernel (#14) attend; the logits are gathered over 'model' in
models/policy.py.  Every matmul reads its weight through
`ops.quant.weight`, which dequantizes an fp8 weight at its use.
FSDP: a block whose leaves are split over 'data' gathers them at its call
(`call_block`, remat's recompute included).  Over 'seq' ranks a train-mode
call takes this rank's columns [B, S / n, D] and the whole rows' key mask
[B, S]; the blocks work on the columns and the attention runs the ring over
the 'seq' group.  A stage of the pipeline ('pipe') holds `layers` of the
model's blocks (`Transformer(..., layers=)`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.ops.quant import weight as dense_weight
from neko_tpu_torch.ops import attention as attn_ops
from neko_tpu_torch.ops.attention_kernel import mask_bounds_from_key_mask, masked_attention
from neko_tpu_torch.ops.decode_attention import quant_cache_attention, quant_rows
from neko_tpu_torch.ops.dropout import Dropout
from neko_tpu_torch.ops.gelu import gelu_erf, gelu_tanh
from neko_tpu_torch.parallel import collectives
from neko_tpu_torch.parallel.collectives import LOCAL, Axis
from neko_tpu_torch.parallel.mesh import active_mesh, seq_ranks

# {"key", "value": [B, H, S, hd], "mask": [B, S]}; an int8 cache adds
# "key_scale", "value_scale": fp32 [B, H, S]
KVCache = Dict[str, torch.Tensor]
# the JAX package's finite fill of disallowed scores in its XLA attention
_BIG_NEG = -1e9


def extend_positions(decode_index, clear_start, K: int, clear_len: int, buffer_len: int):
    """(ring positions of the K chunk tokens [B, K], of the cleared slot
    [B, clear_len]) for `mode='extend'`."""
    dev = decode_index.device
    wpos = (decode_index.long()[:, None] + torch.arange(K, device=dev)) % buffer_len
    cidx = (clear_start.long()[:, None] + torch.arange(clear_len, device=dev)) % buffer_len
    return wpos, cidx


def extend_mask(mask, wpos, cidx):
    """The cache mask after the extend (in place: the slot cleared, the
    chunk set) and the allowed keys of each chunk token, bool [B, K, S]:
    the mask minus the chunk tokens written after it."""
    B, S = mask.shape
    rows = torch.arange(B, device=mask.device)[:, None]
    mask[rows, cidx] = False
    mask[rows, wpos] = True
    onehot = torch.nn.functional.one_hot(wpos, S).int()            # [B, K, S]
    later = onehot.flip(1).cumsum(1).flip(1) - onehot               # written after token i
    return mask[:, None, :] & (later == 0)


def empty_cache(cfg: ModelConfig, rows: int, heads: int, device) -> KVCache:
    """An all-free cache of `rows` rows and `heads` heads (the
    continuous engine's slot pool): zeros, an all-False mask."""
    S, hd = cfg.context_len, cfg.head_dim
    int8 = cfg.kv_cache_dtype == "int8"
    dtype = torch.int8 if int8 else cfg.activation_dtype
    cache = {name: torch.zeros(rows, heads, S, hd, dtype=dtype, device=device)
             for name in ("key", "value")}
    cache["mask"] = torch.zeros(rows, S, dtype=torch.bool, device=device)
    if int8:
        for name in ("key_scale", "value_scale"):
            cache[name] = torch.zeros(rows, heads, S, dtype=torch.float32, device=device)
    return cache


def new_cache(k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, int8: bool) -> KVCache:
    """A prefill's cache of its keys and values [B, H, S, hd] (their int8
    rows and scales on an int8 cache) and a copy of its key mask (decode
    steps flip its entries in place)."""
    if not int8:
        return {"key": k, "value": v, "mask": mask.clone()}
    (kq, ks), (vq, vs) = quant_rows(k), quant_rows(v)
    return {"key": kq, "value": vq, "key_scale": ks, "value_scale": vs, "mask": mask.clone()}


def write_rows(cache: KVCache, index, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write key and value rows ([..., hd], the activation dtype) into the
    cache at `index` (rows, all heads, positions), quantized on an int8
    cache with their scales beside them."""
    if "key_scale" in cache:
        (k, ks), (v, vs) = quant_rows(k), quant_rows(v)
        cache["key_scale"][index] = ks
        cache["value_scale"][index] = vs
    cache["key"][index] = k
    cache["value"][index] = v


def _train_checks(cfg: ModelConfig, S: int) -> None:
    """What train mode refuses: ring attention at hd > 128 (the JAX
    package's XLA ring, not ported) and an S that does not split over the
    'seq' shards."""
    n = attn_ops.seq_shards()
    if n > 1 and attn_ops.wide_heads(cfg.head_dim):
        raise NotImplementedError(
            f"not yet ported to neko_tpu_torch: sequence-parallel attention at "
            f"hd={cfg.head_dim} > 128 (neko_tpu's XLA ring attention)")
    if n > 1 and S % n:
        raise ValueError(f"S={S} does not split over the mesh's {n} sequence shards")


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype` (flax Dense(dtype=...)); an fp8 weight
    is dequantized here, at its use."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), dense_weight(layer, dtype), bias)


def column_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp: Axis):
    """`layer(x)` in `dtype` for a weight whose output rows are this rank's
    block over 'model' (x replicated; its gradient summed over 'model').
    One process: `linear`."""
    if not tp.on:
        return linear(layer, x, dtype)
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return collectives.column_parallel(x.to(dtype), dense_weight(layer, dtype), bias, tp)


def row_parallel(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype, tp: Axis) -> torch.Tensor:
    """`layer(x)` in `dtype` for a weight whose input dim is this rank's
    block over 'model': the partial products summed over it, then the bias,
    rounded once to `dtype`.  One process: `linear`."""
    if not tp.on:
        return linear(layer, x, dtype)
    part = collectives.row_parallel(x.to(dtype), dense_weight(layer, dtype), tp)
    return (part + layer.bias.float()).to(dtype)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`ln(x)` normalized in the weight's dtype, returned in `dtype` (flax
    LayerNorm(dtype=...) reduces in fp32 over fp32 params)."""
    w = ln.weight
    return F.layer_norm(x.to(w.dtype), ln.normalized_shape, w, ln.bias, ln.eps).to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, tp: Axis = LOCAL, seed_offset: int = 0):
        super().__init__()
        self.cfg = cfg
        # tensor parallelism: this rank's H / m heads (parallel/sharding.py)
        self.tp = tp
        self.heads = cfg.heads // tp.size
        # the attention seed's offset for this rank's coordinates (neko_tpu's)
        self.seed_offset = seed_offset
        D = cfg.embed_dim
        Dl = D // tp.size
        # one [3D, D] weight; q, k, v are its three output slices, as the
        # JAX package's SplitProj computes them (this rank's heads of each)
        self.c_attn = nn.Linear(D, 3 * Dl)
        if cfg.lora_r > 0:
            self.lora_a = nn.Linear(D, cfg.lora_r, bias=False)
            self.lora_dropout = Dropout(cfg.lora_dropout)
            self.lora_b = nn.Linear(cfg.lora_r, 3 * Dl, bias=False)
        self.c_proj = nn.Linear(Dl, D)
        self.resid_dropout = Dropout(cfg.dropout)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        B, S, _ = t.shape
        H, hd = self.heads, self.cfg.head_dim
        return t.reshape(B, S, H, hd).transpose(1, 2).contiguous()

    def forward(
        self,
        x: torch.Tensor,                  # [B, S, D] (S == 1 in decode mode)
        input_mask: Optional[torch.Tensor],  # bool [B, S]; train / prefill
        *,
        mode: str,
        cache: Optional[KVCache] = None,
        decode_index: Optional[torch.Tensor] = None,
        decode_bounds=None,
        extend=None,
        generator: Optional[torch.Generator] = None,
    ):
        cfg = self.cfg
        dtype = cfg.activation_dtype
        B, S, D = x.shape
        qkv = column_parallel(self.c_attn, x, dtype, self.tp)
        if cfg.lora_r > 0:
            a = self.lora_dropout(linear(self.lora_a, x, dtype),
                                  generator if mode == "train" else None)
            qkv = qkv + column_parallel(self.lora_b, a, dtype, self.tp) * (
                cfg.lora_alpha / cfg.lora_r)
        if mode == "train" and attn_ops.wide_heads(cfg.head_dim):
            # hd > 128: the plain route, its mask drawn from the generator
            out2d = attn_ops.wide_attention_qkv(
                qkv, input_mask, heads=self.heads, generator=generator, rate=cfg.dropout,
                head_block=(self.tp.index, self.tp.size))
            return self._project_out(out2d, generator), None
        if mode == "train":
            seed, rate = None, 0.0
            if generator is not None and cfg.dropout > 0.0:
                rate = cfg.dropout
                seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                                     device=x.device, generator=generator)
                if self.seed_offset:
                    seed = seed + self.seed_offset  # int32, wrapping as jnp's
            # sequence-parallel first, as the JAX package dispatches
            attend = (attn_ops.sequence_parallel_attention_qkv if attn_ops.seq_shards() > 1
                      else attn_ops.attention_qkv)
            out2d = attend(qkv, input_mask, heads=self.heads, seed=seed, rate=rate)
            return self._project_out(out2d, generator), None
        # this rank's heads (all of them in one process)
        q, k, v = (self._heads(t) for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
        int8 = cfg.kv_cache_dtype == "int8"
        if mode == "prefill":
            # the full-precision k and v attend; the cache stores what its
            # dtype holds
            cache = new_cache(k, v, input_mask, int8)
            out = attn_ops.prefill_attention(q, k, v, input_mask)
        elif mode == "extend":
            wpos, allowed = extend
            rows = torch.arange(B, device=x.device)[:, None]
            write_rows(cache, (rows, slice(None), wpos), k.transpose(1, 2), v.transpose(1, 2))
            if int8:
                out = quant_cache_attention(q, cache["key"], cache["key_scale"], cache["value"],
                                            cache["value_scale"], allowed[:, None],
                                            fill=_BIG_NEG)
            else:
                out = masked_attention(q, cache["key"], cache["value"], allowed[:, None],
                                       fill=_BIG_NEG)
        elif mode == "decode":
            if S != 1:
                raise ValueError("decode mode consumes one token at a time")
            rows = torch.arange(B, device=x.device)
            write_rows(cache, (rows, slice(None), decode_index), k[:, :, 0], v[:, :, 0])
            cache["mask"][rows, decode_index] = True
            if int8:
                out = attn_ops.decode_attention_int8(q[:, :, 0], cache, *decode_bounds)
            else:
                out = attn_ops.decode_attention(q[:, :, 0], cache["key"], cache["value"],
                                                *decode_bounds, cache["mask"])
            out = out[:, :, None]
        else:
            raise NotImplementedError(f"attention mode {mode!r} is not yet ported")
        out2d = out.transpose(1, 2).reshape(B, S, -1)
        return self._project_out(out2d, None), cache

    def _project_out(self, out2d, generator):
        """Shared tail: output projection + residual dropout on [B, S, D]."""
        out = row_parallel(self.c_proj, out2d, self.cfg.activation_dtype, self.tp)
        return self.resid_dropout(out, generator)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, tp: Axis = LOCAL):
        super().__init__()
        self.cfg = cfg
        self.tp = tp  # this rank's block of the 4D width (parallel/sharding.py)
        width = 4 * cfg.embed_dim // tp.size
        self.c_fc = nn.Linear(cfg.embed_dim, width)
        if cfg.activation_fn == "geglu":
            self.gate = nn.Linear(cfg.embed_dim, width)
        self.c_proj = nn.Linear(width, cfg.embed_dim)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dtype = self.cfg.activation_dtype
        act = self.cfg.activation_fn
        h = column_parallel(self.c_fc, x, dtype, self.tp)
        h = gelu_tanh(h) if act == "gelu_new" else gelu_erf(h)
        if act == "geglu":
            h = h * column_parallel(self.gate, x, dtype, self.tp)
        return self.dropout(row_parallel(self.c_proj, h, dtype, self.tp), generator)


class Block(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, cfg: ModelConfig, sd_rate: float = 0.0, tp: Axis = LOCAL,
                 seed_offset: int = 0):
        super().__init__()
        self.cfg = cfg
        # this block's stochastic-depth drop rate (Transformer ramps it)
        self.sd_rate = sd_rate
        self.ln_1 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.attn = Attention(cfg, tp, seed_offset)
        self.ln_2 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.mlp = MLP(cfg, tp)
        # FSDP: the use-site gather of this block's 'data'-split leaves
        # (parallel/sharding.py enable_fsdp), None when it has none
        self.fsdp_gather = None

    def _residual(self, x, branch, generator):
        """x + branch, with per-example drop path in train mode under
        stochastic depth: the branch is zeroed for a random subset of the
        rows, survivors scaled by 1 / keep_p."""
        if generator is None or self.sd_rate <= 0.0:
            return x + branch
        keep_p = 1.0 - self.sd_rate
        keep = drop_path_keep((branch.shape[0], 1, 1), keep_p, generator, branch.device)
        return x + torch.where(keep, branch / keep_p, 0.0).to(branch.dtype)

    def forward(self, x, input_mask, *, mode, cache=None, decode_index=None,
                decode_bounds=None, extend=None, generator=None):
        dtype = self.cfg.activation_dtype
        a, cache = self.attn(
            layer_norm(self.ln_1, x, dtype), input_mask, mode=mode, cache=cache,
            decode_index=decode_index, decode_bounds=decode_bounds, extend=extend,
            generator=generator,
        )
        x = self._residual(x, a, generator)
        x = self._residual(x, self.mlp(layer_norm(self.ln_2, x, dtype), generator), generator)
        return x, cache


def call_block(block: Block, *args, **kw):
    """`block(*args, **kw)`, with its 'data'-split leaves gathered first
    under FSDP (their gradients reduce-scatter back to the shards)."""
    if block.fsdp_gather is None:
        return block(*args, **kw)
    return torch.func.functional_call(block, block.fsdp_gather(), args, kw)


def drop_path_keep(shape, keep_p: float, generator: torch.Generator, device) -> torch.Tensor:
    """The rows a residual branch keeps: bool `shape`, True with
    probability `keep_p`, drawn from `generator`."""
    return torch.rand(shape, generator=generator, device=device) < keep_p


def replay_generator(generator: torch.Generator, state: torch.Tensor) -> torch.Generator:
    """A generator on `generator`'s device set to `state`: what a block's
    recompute under remat draws from."""
    g = torch.Generator(device=generator.device)
    g.set_state(state)
    return g


def remat_block(block: Block, x: torch.Tensor, input_mask, generator):
    """`block(x)` in train mode, its activations recomputed in the backward
    (non-reentrant `torch.utils.checkpoint`).  The forward draws from the
    live `generator`; the recompute from a replay of its state before the
    block, under the mesh that was active in the forward."""
    state = None if generator is None else generator.get_state()
    mesh = active_mesh()
    calls = [0]

    def run(h):
        calls[0] += 1
        if calls[0] == 1:
            return call_block(block, h, input_mask, mode="train", generator=generator)[0]
        g = None if state is None else replay_generator(generator, state)
        with mesh or contextlib.nullcontext():
            return call_block(block, h, input_mask, mode="train", generator=g)[0]

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False)


class Transformer(nn.Module):
    """Stack of pre-LN blocks + final LayerNorm."""

    def __init__(self, cfg: ModelConfig, tp: Axis = LOCAL, seed_offset: int = 0,
                 layers: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        # linear stochastic-depth ramp: layer 0 never drops, the last drops
        # at the configured rate (a pipeline stage, `layers` < cfg.layers,
        # has none: parallel/pipeline.py refuses it)
        self.h = nn.ModuleList(
            Block(cfg, cfg.stochastic_depth * i / max(cfg.layers - 1, 1), tp, seed_offset)
            for i in range(cfg.layers if layers is None else layers))
        self.ln_f = nn.LayerNorm(cfg.embed_dim, eps=1e-5)

    def forward(
        self,
        x: torch.Tensor,
        input_mask: Optional[torch.Tensor],
        *,
        mode: str,
        caches: Optional[List[KVCache]] = None,
        decode_index: Optional[torch.Tensor] = None,
        extend_clear: Optional[tuple] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns (hidden [B, S, D], per-layer KV caches; None in train
        mode).  `generator` (train mode only) turns dropout on.
        `extend_clear` = (clear_start int [B], clear_len, buffer_len) in
        the ring extend mode; None is the append mode."""
        if mode in ("decode", "extend") and caches is None:
            raise ValueError(f"{mode} mode needs the caches prefill returned")
        if mode == "train":  # the whole sequence's S, its columns over 'seq' ranks
            _train_checks(self.cfg, x.shape[1] * seq_ranks(active_mesh()))
        bounds = None
        if mode == "decode":
            # the layers' masks are equal; the window includes the row this
            # step writes
            mask = caches[0]["mask"].clone()
            mask[torch.arange(x.shape[0], device=x.device), decode_index] = True
            bounds = mask_bounds_from_key_mask(mask)
        extend = None
        if mode == "extend" and extend_clear is None:
            # append: monotone writes, validity by the column compare alone
            wpos = decode_index[:, None] + torch.arange(x.shape[1], device=x.device)
            col = torch.arange(caches[0]["key"].shape[2], device=x.device)
            extend = (wpos, col[None, None, :] <= wpos[:, :, None])
        elif mode == "extend":
            clear_start, clear_len, buffer_len = extend_clear
            wpos, cidx = extend_positions(decode_index, clear_start, x.shape[1],
                                          clear_len, buffer_len)
            # the layers' masks are equal: compute the allowed keys once, then
            # leave every layer's mask as the first one's
            allowed = extend_mask(caches[0]["mask"], wpos, cidx)
            for c in caches[1:]:
                c["mask"].copy_(caches[0]["mask"])
            extend = (wpos, allowed)
        out_caches = []
        if mode == "train" and self.cfg.remat and torch.is_grad_enabled():
            for block in self.h:
                x = remat_block(block, x, input_mask, generator)
            return layer_norm(self.ln_f, x, self.cfg.activation_dtype), None
        for i, block in enumerate(self.h):
            x, c = call_block(
                block, x, input_mask, mode=mode,
                cache=None if caches is None else caches[i],
                decode_index=decode_index, decode_bounds=bounds, extend=extend,
                generator=generator,
            )
            out_caches.append(c)
        hidden = layer_norm(self.ln_f, x, self.cfg.activation_dtype)
        return hidden, (None if mode == "train" else out_caches)
