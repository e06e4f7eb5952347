"""Decoder-only transformer core (counterpart of
neko_tpu/models/transformer.py).

* pre-LN blocks: x + attn(ln_1(x)); x + mlp(ln_2(x)); no absolute position
  embedding (positions come from the structured encodings upstream).
* `mode='train'`: full causal attention over the packed context through the
  head-packed kernels (whole-head up to S = 1024, blocked above, any S, hd in
  {32, 64, 128}): q, k and v stay the three column slices of the one
  [B, S, 3D] `c_attn` output (no transpose, one gradient buffer), with
  attention, residual and MLP dropout when a `generator` (the step's
  `torch.Generator`) is given.  Under an active mesh whose 'seq' axis has
  more than one shard (`parallel/mesh.py`) the attention runs as ring
  attention over the sequence shards instead (`ops/ring_kernel.py`), before
  the whole-head / blocked dispatch, as the JAX package routes it; S must
  split over the axis.  Each layer draws its attention seed as an
  int32 [1] tensor on the device from that generator, as the JAX package
  draws one per layer from its dropout stream.  Without a generator the
  pass is deterministic (eval loss).
* `mode='prefill'`: full causal attention through the whole-head kernel
  wrapper on [B, H, S, hd] (always: `cfg.attention_impl` is carried for
  config round trips and ignored), returning each layer's KV cache: keys and
  values [B, H, S, hd] in the activation dtype plus the bool [B, S] key mask.
* `mode='decode'`: one token per row written at `decode_index` (the caller
  passes `pos % context_len` for the ring), then attention of that token over
  the cached keys through the decode kernel (#14, `ops/decode_attention.py`).
  The cache tensors are updated IN PLACE: unlike the JAX package's
  functional cache, a decode step mutates the cache it is given.  The
  kernel takes the valid cache rows as one window [start, end) per row,
  computed once a step from the cache mask with the new row set: the
  generator's mask is always one contiguous run ([0, pos] for right-padded
  prompts; every row once the ring has wrapped, and attention over the
  cache does not depend on the order of its rows).

Mixed precision by explicit casts, as flax does it (not torch.autocast,
whose LayerNorm returns fp32): each Linear casts its input and its fp32
weight to `cfg.dtype`; each LayerNorm normalizes in the dtype of its weight
(fp32 when training) and returns `cfg.dtype`.  Served weights are already in
the activation dtype, so there every cast is a no-op.  Attention logits and
softmax are fp32.

Not ported yet (configs asking for them raise NotImplementedError): the
'extend' mode, the int8 cache, LoRA, GEGLU and the tanh GELU ('gelu_new');
in train mode also stochastic depth and `remat`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.ops import attention as attn_ops
from neko_tpu_torch.ops.attention_kernel import mask_bounds_from_key_mask
from neko_tpu_torch.ops.dropout import Dropout
from neko_tpu_torch.ops.gelu import gelu_erf

KVCache = Dict[str, torch.Tensor]  # {"key", "value": [B,H,S,hd], "mask": [B,S]}


def _not_ported(cfg: ModelConfig) -> None:
    unported = {
        f"activation_fn={cfg.activation_fn!r}": cfg.activation_fn != "gelu",
        "kv_cache_dtype='int8'": cfg.kv_cache_dtype != "native",
        "lora_r > 0": cfg.lora_r > 0,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"not yet ported to neko_tpu_torch: {bad}")


def _train_not_ported(cfg: ModelConfig, S: int) -> None:
    unported = {
        "stochastic_depth > 0": cfg.stochastic_depth > 0,
        "remat": cfg.remat,
        f"training at S={S}, hd={cfg.head_dim} (the head-packed kernels take "
        "hd in 32/64/128)":
            not attn_ops.packed_ok(S, cfg.head_dim, cfg.heads),
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"not yet ported to neko_tpu_torch: {bad}")
    n = attn_ops.seq_shards()
    if n > 1 and S % n:
        raise ValueError(f"S={S} does not split over the mesh's {n} sequence shards")


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`layer(x)` computed in `dtype` (flax Dense(dtype=...))."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`ln(x)` normalized in the weight's dtype, returned in `dtype` (flax
    LayerNorm(dtype=...) reduces in fp32 over fp32 params)."""
    w = ln.weight
    return F.layer_norm(x.to(w.dtype), ln.normalized_shape, w, ln.bias, ln.eps).to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        # one [3D, D] weight; q, k, v are its three output slices, as the
        # JAX package's SplitProj computes them
        self.c_attn = nn.Linear(D, 3 * D)
        self.c_proj = nn.Linear(D, D)
        self.resid_dropout = Dropout(cfg.dropout)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        B, S, _ = t.shape
        H, hd = self.cfg.heads, self.cfg.head_dim
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
        generator: Optional[torch.Generator] = None,
    ):
        cfg = self.cfg
        dtype = cfg.activation_dtype
        B, S, D = x.shape
        qkv = linear(self.c_attn, x, dtype)
        if mode == "train":
            seed, rate = None, 0.0
            if generator is not None and cfg.dropout > 0.0:
                rate = cfg.dropout
                seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32,
                                     device=x.device, generator=generator)
            # sequence-parallel first, as the JAX package dispatches
            attend = (attn_ops.sequence_parallel_attention_qkv if attn_ops.seq_shards() > 1
                      else attn_ops.attention_qkv)
            out2d = attend(qkv, input_mask, heads=cfg.heads, seed=seed, rate=rate)
            return self._project_out(out2d, generator), None
        q, k, v = (self._heads(t) for t in qkv.split(D, dim=-1))
        if mode == "prefill":
            # the mask is copied: decode steps flip its entries in place
            cache = {"key": k, "value": v, "mask": input_mask.clone()}
            out = attn_ops.prefill_attention(q, k, v, input_mask)
        elif mode == "decode":
            if S != 1:
                raise ValueError("decode mode consumes one token at a time")
            rows = torch.arange(B, device=x.device)
            cache["key"][rows, :, decode_index] = k[:, :, 0]
            cache["value"][rows, :, decode_index] = v[:, :, 0]
            cache["mask"][rows, decode_index] = True
            out = attn_ops.decode_attention(
                q[:, :, 0], cache["key"], cache["value"], *decode_bounds)[:, :, None]
        else:
            raise NotImplementedError(f"attention mode {mode!r} is not yet ported")
        out2d = out.transpose(1, 2).reshape(B, S, D)
        return self._project_out(out2d, None), cache

    def _project_out(self, out2d, generator):
        """Shared tail: output projection + residual dropout on [B, S, D]."""
        out = linear(self.c_proj, out2d, self.cfg.activation_dtype)
        return self.resid_dropout(out, generator)


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.c_fc = nn.Linear(cfg.embed_dim, 4 * cfg.embed_dim)
        self.c_proj = nn.Linear(4 * cfg.embed_dim, cfg.embed_dim)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        dtype = self.cfg.activation_dtype
        h = gelu_erf(linear(self.c_fc, x, dtype))
        return self.dropout(linear(self.c_proj, h, dtype), generator)


class Block(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_1 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.attn = Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.mlp = MLP(cfg)

    def forward(self, x, input_mask, *, mode, cache=None, decode_index=None,
                decode_bounds=None, generator=None):
        dtype = self.cfg.activation_dtype
        a, cache = self.attn(
            layer_norm(self.ln_1, x, dtype), input_mask, mode=mode, cache=cache,
            decode_index=decode_index, decode_bounds=decode_bounds, generator=generator,
        )
        x = x + a
        x = x + self.mlp(layer_norm(self.ln_2, x, dtype), generator)
        return x, cache


class Transformer(nn.Module):
    """Stack of pre-LN blocks + final LayerNorm."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _not_ported(cfg)
        self.cfg = cfg
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        self.ln_f = nn.LayerNorm(cfg.embed_dim, eps=1e-5)

    def forward(
        self,
        x: torch.Tensor,
        input_mask: Optional[torch.Tensor],
        *,
        mode: str,
        caches: Optional[List[KVCache]] = None,
        decode_index: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Returns (hidden [B, S, D], per-layer KV caches; None in train
        mode).  `generator` (train mode only) turns dropout on."""
        if mode == "decode" and caches is None:
            raise ValueError("decode mode needs the caches prefill returned")
        if mode == "train":
            _train_not_ported(self.cfg, x.shape[1])
        bounds = None
        if mode == "decode":
            # the layers' masks are equal; the window includes the row this
            # step writes
            mask = caches[0]["mask"].clone()
            mask[torch.arange(x.shape[0], device=x.device), decode_index] = True
            bounds = mask_bounds_from_key_mask(mask)
        out_caches = []
        for i, block in enumerate(self.h):
            x, c = block(
                x, input_mask, mode=mode,
                cache=None if caches is None else caches[i],
                decode_index=decode_index, decode_bounds=bounds, generator=generator,
            )
            out_caches.append(c)
        hidden = layer_norm(self.ln_f, x, self.cfg.activation_dtype)
        return hidden, (None if mode == "train" else out_caches)
