"""Plain ring attention: causal attention over a sequence cut into shards
(counterpart of neko_tpu/ops/ring_attention.py).

The blockwise formulation (Liu et al., Ring Attention) in plain torch: each
shard holds a block of queries, meets the key/value blocks (and key-mask
blocks) of the shards before it one ring step at a time, and keeps a stable
online softmax (m, l, acc) per query row.  A step forms the block pair's
[B, H, S_local, S_local] fp32 scores, which is what the per-pair kernels of
ops/ring_kernel.py avoid.

In the port this is the plain version of the ring as a whole: the tests and
the checks hold `ring_kernel.ring_attention_bsd` against it.  It is written
from the global view, as the JAX package's `sequence_sharded_attention` is
called: the tensors hold every shard, and the ring's rotation is the index
(i - t) mod n.  Nothing on the train path calls it.

Dropout comes as the fp32 keep/scale matrices [B, H, S, S] (sliced per block
pair), applied to the unnormalized exp weights while l gathers the undropped
mass: the same as dropping the normalized probabilities.  Rows whose keys are
all masked give zeros.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def _block(q32, q_pos, k_blk, v_blk, k_pos, mask_blk, m, l, acc, ks_blk):
    """One online-softmax accumulation against a single kv block."""
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k_blk.float())
    allowed = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if mask_blk is not None:
        allowed = allowed & mask_blk[:, None, None, :]
    s = torch.where(allowed, s, _NEG)

    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    # where the whole row is masked so far m_new is the fill and exp(0) = 1
    # would count hidden keys: such weights are forced to 0
    p = torch.exp(s - m_new) * allowed
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1, keepdim=True)
    p_v = p if ks_blk is None else p * ks_blk
    acc_new = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p_v, v_blk.float())
    return m_new, l_new, acc_new


def ring_attention(
    q: torch.Tensor,  # [B, H, S, hd]: every shard's query block, in order
    k: torch.Tensor,
    v: torch.Tensor,
    n_shards: int,
    sm_scale: Optional[float] = None,
    key_mask: Optional[torch.Tensor] = None,    # bool [B, S]
    keep_scale: Optional[torch.Tensor] = None,  # fp32 [B, H, S, S]
) -> torch.Tensor:
    """Causal attention over `n_shards` sequence blocks, shard i owning the
    positions [i * S_local, (i + 1) * S_local).  Returns [B, H, S, hd] in q's
    dtype."""
    B, H, S, hd = q.shape
    if S % n_shards:
        raise ValueError(f"S={S} does not split into {n_shards} sequence shards")
    S_l = S // n_shards
    scale = hd ** -0.5 if sm_scale is None else sm_scale
    out = torch.empty_like(q)
    for i in range(n_shards):
        rows = slice(i * S_l, (i + 1) * S_l)
        q32 = q[:, :, rows].float() * scale
        q_pos = torch.arange(rows.start, rows.stop, device=q.device)
        m = torch.full((B, H, S_l, 1), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, S_l, hd, dtype=torch.float32, device=q.device)
        for t in range(n_shards):
            src = (i - t) % n_shards  # the block that has travelled t hops
            cols = slice(src * S_l, (src + 1) * S_l)
            k_pos = torch.arange(cols.start, cols.stop, device=q.device)
            m, l, acc = _block(
                q32, q_pos, k[:, :, cols], v[:, :, cols], k_pos,
                None if key_mask is None else key_mask[:, cols], m, l, acc,
                None if keep_scale is None else keep_scale[:, :, rows, cols])
        # rows with zero attended mass (fully-masked queries) -> zeros, not NaN
        out[:, :, rows] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out
