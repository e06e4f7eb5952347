"""Attention implementations (counterpart of neko_tpu/ops/attention.py).

* `xla_attention`: the JAX package's plain path (it runs wherever no TPU
  kernel applies), written in torch: fp32 logits, finite -1e9 fill, fp32
  softmax, weights cast to the value dtype.  Dropout comes as a materialized
  fp32 keep/scale matrix, because this is also the plain oracle the tests
  hold the kernels against with the same mask.
* Wide heads (hd > 128, over the kernels' widest compiled head,
  `wide_heads`): the JAX package has no Pallas kernel there and runs its
  XLA attention; the port routes every mode there too, by shape, before any
  launch: training through `wide_attention_qkv` (`xla_attention` with a
  keep mask drawn from the step's `torch.Generator`, kept with probability
  1 - rate and scaled by 1 / (1 - rate), so E[dropout(x)] = x), the prefill
  through `xla_attention` over the key mask, the decode step through plain
  attention over the cache mask (an int8 cache through
  `quant_cache_attention`).  Query rows with no key come out as zeros, as
  from the kernels.  No kernel launches on this route, as no Pallas kernel
  runs on the JAX package's.  Ring attention at hd > 128 (the JAX
  package's XLA ring) is not ported: a 'seq' axis refuses it by name.
* `decode_attention`: the decode-step dispatch: one query per (row, head)
  over the valid KV cache rows (the cache mask) inside the window
  [start, end), through `decode_cache_attention` (kernel #14 on a CUDA
  tensor, its plain version on a CPU one), the only decode path of the
  port's model at hd <= 128.  The JAX package's decode step runs XLA
  einsums over a mask bias and never its kernel.  `decode_attention_int8` is the same over an
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
  blocked ones (#6-#9, `blocked_attention.py`): any S, any hd <= 128 (the
  kernels' wrappers pad hd to a compiled width), as the JAX package's
  whole-head kernel takes; wider heads take the plain route (`wide_heads`).
* `sequence_parallel_attention_qkv` / `_bsd`: the train path under a mesh
  whose 'seq' axis has more than one shard (the JAX package's
  `sequence_parallel_attention_bsd`): ring attention with the per-pair
  kernels #11-#13 (`ring_kernel.py`).  The global key bounds are computed
  once from the key mask; nothing mask-shaped travels around the ring.
  `seq_shards()` reads the active mesh and `packed_ring_ok` says which
  shapes the ring takes: S a multiple of the axis size, hd <= 128.
"""

from __future__ import annotations

from typing import Optional

import torch

from neko_tpu_torch.ops import attention_kernel as whk
from neko_tpu_torch.ops import blocked_attention, ring_kernel
from neko_tpu_torch.ops.decode_attention import (decode_cache_attention,
                                                 decode_cache_attention_int8,
                                                 quant_cache_attention)
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


def wide_heads(hd: int) -> bool:
    """True above the kernels' widest head (hd > 128): the plain route."""
    return hd > whk.MAX_HEAD_DIM


def _no_key_rows_zeroed(out, allowed):
    """`out` with the query rows that have no allowed key set to 0."""
    return out.masked_fill(~allowed.any(dim=-1, keepdim=True), 0)


def wide_attention(q, k, v, key_mask, keep_scale=None):
    """`xla_attention` with the query rows that have no key zeroed: the
    prefill and train attention at hd > 128."""
    S = q.shape[2]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    allowed = causal[None, None] & key_mask[:, None, None, :]
    return _no_key_rows_zeroed(xla_attention(q, k, v, key_mask, keep_scale), allowed)


def wide_keep_scale(shape, rate: float, generator: torch.Generator, device,
                    heads: Optional[slice] = None) -> torch.Tensor:
    """fp32 [B, H, S, S] dropout keep/scale of the plain route: each
    probability kept with chance 1 - rate (uniforms from `generator`) and
    scaled by 1 / (1 - rate).  `heads` takes this rank's heads of a draw
    over all of them (tensor parallelism), so the mask is the one process's."""
    keep = torch.rand(shape, generator=generator, device=device) >= rate
    if heads is not None:
        keep = keep[:, heads]
    return keep.float() / (1.0 - rate)


def wide_attention_qkv(qkv, key_mask, *, heads, generator=None, rate=0.0,
                       head_block=(0, 1)):
    """`attention_qkv` at hd > 128: the head-packed [B, S, 3*H*hd] input as
    [B, H, S, hd] views, `wide_attention` with dropout at `rate` from
    `generator` (None: no dropout) -> [B, S, H*hd].  `head_block` = (this
    rank's index, ranks) over 'model': the mask is drawn for every head and
    this rank takes its block."""
    B, S, _ = qkv.shape
    q, k, v = (t.reshape(B, S, heads, -1).transpose(1, 2)
               for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
    ks = None
    if generator is not None and rate > 0.0:
        index, ranks = head_block
        ks = wide_keep_scale((B, heads * ranks, S, S), rate, generator, qkv.device,
                             slice(index * heads, (index + 1) * heads))
    return wide_attention(q, k, v, key_mask, ks).transpose(1, 2).reshape(B, S, -1)


def decode_attention(q, key, value, start, end, key_mask):
    """Decode attention of q [B, H, hd] over the cache [B, H, S, hd] at the
    rows of the bool [B, S] cache mask inside [start, end) (int32 [B] each)
    -> [B, H, hd]; plain attention over the cache mask at hd > 128."""
    if wide_heads(q.shape[-1]):
        allowed = key_mask[:, None, None, :]
        return whk.masked_attention(q[:, :, None], key, value, allowed, fill=_BIG_NEG)[:, :, 0]
    return decode_cache_attention(q, key, value, start, end, key_mask)


def decode_attention_int8(q, cache, start, end):
    """`decode_attention` over an int8 cache (its "key" / "value" int8 rows,
    "key_scale" / "value_scale" fp32 row scales, "mask"); the plain
    `quant_cache_attention` at hd > 128."""
    if wide_heads(q.shape[-1]):
        return quant_cache_attention(q[:, :, None], cache["key"], cache["key_scale"],
                                     cache["value"], cache["value_scale"],
                                     cache["mask"][:, None, None, :], fill=_BIG_NEG)[:, :, 0]
    return decode_cache_attention_int8(q, cache["key"], cache["key_scale"], cache["value"],
                                       cache["value_scale"], start, end, cache["mask"])


def prefill_attention(q, k, v, key_mask):
    """Whole-head attention over a packer mask (contiguous valid run per
    row); `wide_attention` at hd > 128.  q,k,v: [B, H, S, hd] contiguous;
    key_mask: bool [B, S]."""
    if wide_heads(q.shape[-1]):
        return wide_attention(q, k, v, key_mask)
    start, end = whk.mask_bounds_from_key_mask(key_mask)
    return whk.whole_head_attention(q, k, v, start, end)


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
