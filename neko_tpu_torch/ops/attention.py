"""Attention implementations (counterpart of neko_tpu/ops/attention.py).

* `xla_attention`: the JAX package's plain path (it runs wherever no TPU
  kernel applies), written in torch: fp32 logits, finite -1e9 fill, fp32
  softmax, weights cast to the value dtype.  Dropout comes as a materialized
  fp32 keep/scale matrix, because this is the plain oracle the tests hold
  the kernels against with the same mask.  The port's model does not call
  it.
* `decode_attention`: the decode-step dispatch: one query per (row, head)
  over the valid KV cache rows (the cache mask) inside the window
  [start, end), through `decode_cache_attention` (kernel #14 on a CUDA
  tensor, its plain version on a CPU one), the only decode path of the
  port's model.  The JAX package's decode step runs XLA einsums over a mask
  bias and never its kernel.  `decode_attention_int8` is the same over an
  int8 cache (#14's int8 path; neko_tpu's `_quant_cache_attention`).
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
  output, with attention dropout.  As `_kernel_local_bsd` dispatches, S <=
  1024 goes to the whole-head kernels (#1-#4) and longer contexts to the
  blocked ones (#6-#9, `blocked_attention.py`).  `packed_ok` says which
  shapes the port trains: any S, any hd <= 128 (the kernels' wrappers pad
  hd to a compiled width), as the JAX package's whole-head kernel takes.
* `sequence_parallel_attention_qkv` / `_bsd`: the train path under a mesh
  whose 'seq' axis has more than one shard (the JAX package's
  `sequence_parallel_attention_bsd`): ring attention with the per-pair
  kernels #11-#13 (`ring_kernel.py`).  The global key bounds are computed
  once from the key mask; nothing mask-shaped travels around the ring.
  `seq_shards()` reads the active mesh and `packed_ring_ok` says which
  shapes the ring takes: S a multiple of the axis size, hd <= 128.
"""

from __future__ import annotations

import torch

from neko_tpu_torch.ops import attention_kernel as whk
from neko_tpu_torch.ops import blocked_attention, ring_kernel
from neko_tpu_torch.ops.decode_attention import (decode_cache_attention,
                                                 decode_cache_attention_int8)
from neko_tpu_torch.parallel.mesh import active_mesh, seq_axis_size

_BIG_NEG = -1e9
# The whole-head kernels train S <= 1024, as in the JAX package; longer
# contexts go to the blocked kernels.
_WHOLE_HEAD_MAX_S = 1024


def xla_attention(q, k, v, key_mask, keep_scale=None):
    """Causal attention with key-padding mask; fp32 softmax.
    q,k,v: [B, H, S, hd]; key_mask: bool [B, S]; keep_scale: optional fp32
    [B, H, S, S] dropout keep/scale applied to the probabilities."""
    S = q.shape[2]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None, None] & key_mask[:, None, None, :]
    return whk.masked_attention(q, k, v, allowed, fill=_BIG_NEG, keep_scale=keep_scale)


def decode_attention(q, key, value, start, end, key_mask):
    """Decode attention of q [B, H, hd] over the cache [B, H, S, hd] at the
    rows of the bool [B, S] cache mask inside [start, end) (int32 [B] each)
    -> [B, H, hd]."""
    return decode_cache_attention(q, key, value, start, end, key_mask)


def decode_attention_int8(q, cache, start, end):
    """`decode_attention` over an int8 cache (its "key" / "value" int8 rows,
    "key_scale" / "value_scale" fp32 row scales, "mask")."""
    return decode_cache_attention_int8(q, cache["key"], cache["key_scale"], cache["value"],
                                       cache["value_scale"], start, end, cache["mask"])


def prefill_attention(q, k, v, key_mask):
    """Whole-head attention over a packer mask (contiguous valid run per
    row).  q,k,v: [B, H, S, hd] contiguous; key_mask: bool [B, S]."""
    start, end = whk.mask_bounds_from_key_mask(key_mask)
    return whk.whole_head_attention(q, k, v, start, end)


def packed_ok(S: int, hd: int, heads: int) -> bool:
    """True when the head-packed kernels serve this training shape: the
    whole-head ones up to S = 1024, the blocked ones above, both for any
    hd <= 128."""
    return heads > 0 and blocked_attention.supported(S, hd)


def attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
    """Head-packed attention of the three column slices of one
    [B, S, 3*H*hd] projection output; returns [B, S, H*hd], and its gradient
    is one [B, S, 3*H*hd] buffer.  seed is an int32 [1] tensor on the device
    (needed when rate > 0)."""
    start, end = whk.mask_bounds_from_key_mask(key_mask)
    fn = (whk.whole_head_attention_qkv if qkv.shape[1] <= _WHOLE_HEAD_MAX_S
          else blocked_attention.blocked_attention_qkv)
    return fn(qkv, start, end, seed, heads=heads, dropout_rate=rate)


def seq_shards() -> int:
    """Size of the 'seq' axis of the active mesh (1 when no mesh / no axis)."""
    return seq_axis_size(active_mesh())


def packed_ring_ok(S: int, hd: int, heads: int) -> bool:
    """True when the ring kernels serve this sequence-sharded shape: a 'seq'
    axis of more than one shard is active, the global S splits over it and
    hd <= 128."""
    n = seq_shards()
    return n > 1 and heads > 0 and S % n == 0 and ring_kernel.supported(S // n, hd)


def _ring_args(key_mask):
    """(global start, global end, shards, process group or None) of the
    active mesh's ring."""
    mesh = active_mesh()
    n = seq_axis_size(mesh)
    if n <= 1:
        raise ValueError("sequence-parallel attention needs an active mesh with seq > 1")
    start, end = whk.mask_bounds_from_key_mask(key_mask)
    return start, end, n, mesh.seq_group


def sequence_parallel_attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
    """`attention_qkv` as ring attention over the active mesh's 'seq' axis.
    With the shards on one device qkv is the global [B, S, 3*H*hd] tensor;
    with the shards on the ranks of a process group it is this rank's
    [B, S / n, 3*H*hd] block.  key_mask is the GLOBAL bool [B, S] mask either
    way, and seed (int32 [1] on the device) the same on every rank.  Check
    `packed_ring_ok(S, hd, heads)` first."""
    start, end, n, group = _ring_args(key_mask)
    return ring_kernel.ring_attention_qkv(qkv, start, end, seed, n_shards=n, heads=heads,
                                          group=group, dropout_rate=rate)


def sequence_parallel_attention_bsd(q, k, v, key_mask, *, heads, dropout_seed=None,
                                    dropout_rate=0.0):
    """Ring attention in the head-packed [B, S, H*hd] layout (the JAX
    signature); q, k, v as `sequence_parallel_attention_qkv` takes qkv."""
    start, end, n, group = _ring_args(key_mask)
    return ring_kernel.ring_attention_bsd(q, k, v, start, end, dropout_seed, n_shards=n,
                                          heads=heads, group=group, dropout_rate=dropout_rate)
