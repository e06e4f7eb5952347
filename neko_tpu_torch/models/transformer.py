"""Decoder-only transformer core, serving modes (counterpart of
neko_tpu/models/transformer.py).

* pre-LN blocks: x + attn(ln_1(x)); x + mlp(ln_2(x)); no absolute position
  embedding (positions come from the structured encodings upstream).
* `mode='prefill'`: full causal attention over the packed context through
  the whole-head kernel wrapper (always: `cfg.attention_impl` is carried for
  config round trips and ignored), returning each layer's KV cache: keys and
  values [B, H, S, hd] in the activation dtype plus the bool [B, S] key mask.
* `mode='decode'`: one token per row written at `decode_index` (the caller
  passes `pos % context_len` for the ring), then attention of that token over
  the cached keys.  The cache tensors are updated IN PLACE: unlike the JAX
  package's functional cache, a decode step mutates the cache it is given.

Computation runs in the parameters' dtype (the generator casts served
weights to the activation dtype); attention logits and softmax are fp32.
Train mode, dropout, the 'extend' mode, the int8 cache, LoRA, GEGLU, the
tanh GELU ('gelu_new') and stochastic depth are not ported yet; configs
asking for them raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.ops import attention as attn_ops
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


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        # one [3D, D] weight; q, k, v are its three output slices, as the
        # JAX package's SplitProj computes them
        self.c_attn = nn.Linear(D, 3 * D)
        self.c_proj = nn.Linear(D, D)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        B, S, _ = t.shape
        H, hd = self.cfg.heads, self.cfg.head_dim
        return t.reshape(B, S, H, hd).transpose(1, 2).contiguous()

    def forward(
        self,
        x: torch.Tensor,                  # [B, S, D] (S == 1 in decode mode)
        input_mask: Optional[torch.Tensor],  # bool [B, S]; prefill only
        *,
        mode: str,
        cache: Optional[KVCache] = None,
        decode_index: Optional[torch.Tensor] = None,
    ):
        B, S, D = x.shape
        q, k, v = (self._heads(t) for t in self.c_attn(x).split(D, dim=-1))
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
            out = attn_ops.cache_attention(
                q, cache["key"], cache["value"], cache["mask"])
        else:
            raise NotImplementedError(f"attention mode {mode!r} is not yet ported")
        out2d = out.transpose(1, 2).reshape(B, S, D)
        return self.c_proj(out2d), cache


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.c_fc = nn.Linear(cfg.embed_dim, 4 * cfg.embed_dim)
        self.c_proj = nn.Linear(4 * cfg.embed_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(gelu_erf(self.c_fc(x)))


class Block(nn.Module):
    """One pre-LN transformer block."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln_1 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.attn = Attention(cfg)
        self.ln_2 = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        self.mlp = MLP(cfg)

    def forward(self, x, input_mask, *, mode, cache=None, decode_index=None):
        a, cache = self.attn(
            self.ln_1(x), input_mask, mode=mode, cache=cache,
            decode_index=decode_index,
        )
        x = x + a
        x = x + self.mlp(self.ln_2(x))
        return x, cache


class Transformer(nn.Module):
    """Stack of pre-LN blocks + final LayerNorm."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _not_ported(cfg)
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
    ):
        """Returns (hidden [B, S, D], per-layer KV caches)."""
        if mode == "decode" and caches is None:
            raise ValueError("decode mode needs the caches prefill returned")
        out_caches = []
        for i, block in enumerate(self.h):
            x, c = block(
                x, input_mask, mode=mode,
                cache=None if caches is None else caches[i],
                decode_index=decode_index,
            )
            out_caches.append(c)
        return self.ln_f(x), out_caches
