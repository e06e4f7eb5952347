"""Attention implementations (counterpart of neko_tpu/ops/attention.py).

* `xla_attention`: the JAX package's plain path (it runs wherever no TPU
  kernel applies), written in torch: fp32 logits, finite -1e9 fill, fp32
  softmax, weights cast to the value dtype.  Dropout comes as a materialized
  fp32 keep/scale matrix, because this is the plain oracle the tests hold
  the kernels against with the same mask.  The port's model does not call
  it.
* `cache_attention`: the same plain body for the decode step, over the KV
  cache's key mask.
* `prefill_attention`: the prefill dispatch (the JAX package's
  `tpu_flash_attention` -> `_kernel_local`), the only prefill path of the
  port's model.  The key mask becomes per-row [start, end) bounds and goes to
  `whole_head_attention`, which runs the CUDA kernel on a CUDA tensor and the
  plain version on a CPU tensor.  One Hopper kernel serves every prefill
  shape it takes; the JAX package sends S > 1024 to a separate bundled flash
  kernel.
* `attention_qkv`: the train path (the JAX package's
  `tpu_flash_attention_bsd` -> `_kernel_local_bsd` on one device): the
  head-packed q, k, v as the column slices of one [B, S, 3*H*hd] projection
  output, with attention dropout, through the same kernels.  `packed_ok`
  says which shapes the port trains.
"""

from __future__ import annotations

import torch

from neko_tpu_torch.ops import attention_kernel as whk

_BIG_NEG = -1e9
# The JAX package's whole-head kernel serves S <= 1024; longer training
# contexts go to its blocked kernels (#6-#10), which are not ported yet.
_PACKED_MAX_S = 1024


def xla_attention(q, k, v, key_mask, keep_scale=None):
    """Causal attention with key-padding mask; fp32 softmax.
    q,k,v: [B, H, S, hd]; key_mask: bool [B, S]; keep_scale: optional fp32
    [B, H, S, S] dropout keep/scale applied to the probabilities."""
    S = q.shape[2]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None, None] & key_mask[:, None, None, :]
    return whk.masked_attention(q, k, v, allowed, fill=_BIG_NEG, keep_scale=keep_scale)


def cache_attention(q, key, value, cache_mask):
    """Decode attention of q [B, H, 1, hd] over the cache [B, H, S, hd] at
    the valid entries of cache_mask bool [B, S] (the XLA einsums of the JAX
    package's decode mode)."""
    return whk.masked_attention(
        q, key, value, cache_mask[:, None, None, :], fill=_BIG_NEG)


def prefill_attention(q, k, v, key_mask):
    """Whole-head attention over a packer mask (contiguous valid run per
    row).  q,k,v: [B, H, S, hd] contiguous; key_mask: bool [B, S]."""
    start, end = whk.mask_bounds_from_key_mask(key_mask)
    return whk.whole_head_attention(q, k, v, start, end)


def packed_ok(S: int, hd: int, heads: int) -> bool:
    """True when the head-packed kernels serve this training shape: a head
    dim the kernels take and S within the whole-head kernel's range."""
    return heads > 0 and 0 < S <= _PACKED_MAX_S and hd in whk._KERNEL_HEAD_DIMS


def attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
    """Head-packed attention of the three column slices of one
    [B, S, 3*H*hd] projection output; returns [B, S, H*hd], and its gradient
    is one [B, S, 3*H*hd] buffer.  seed is an int32 [1] tensor on the device
    (needed when rate > 0)."""
    start, end = whk.mask_bounds_from_key_mask(key_mask)
    return whk.whole_head_attention_qkv(qkv, start, end, seed, heads=heads,
                                        dropout_rate=rate)
