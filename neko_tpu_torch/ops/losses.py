"""Chunked masked softmax cross-entropy over a large vocabulary
(counterpart of neko_tpu/ops/losses.py).

Both losses go through one `autograd.Function` per chunk, the port of the
JAX package's `_chunk_nll` custom VJP: the forward keeps only the per-row
log-partition `logz` (and the target logit), and the backward recomputes the
chunk's logits with one head matmul and forms
dlogits = (softmax - onehot) * mask * g directly.  So no chunk's [C, V] fp32
logits outlive its own forward or backward.

* `gathered_masked_xent`: the head runs only at the packer's gathered
  target positions (`loss_pos` / `loss_tgt`, data/batch.py), the train
  step's loss.
* `chunked_masked_xent`: shifted next-token CE over every position, chunks
  of `chunk_size` positions (the JAX package wraps its chunk in
  `jax.checkpoint`; the gradient is the same).

`weight` is the torch head weight [V, D] (the JAX kernel is its transpose).
The forward's (logz, target logit), the JAX package's `_logz_tl`, goes
through `loss_kernel.fused_logz_tl` wherever `loss_kernel.fused_supported`
takes the shape and dtype (bf16, D % 8 == 0): on the card the fused
loss-head kernel #15 (no [C, V] logits), on the CPU its plain version.  Any
other chunk (fp32 hidden, an odd D) takes the logits route: the cuBLAS
product, then torch's logsumexp and gather.  The JAX package computes the
same function in XLA.  The logits come out in fp32 from bf16 operands (fp32
sums, no bf16 rounding of the [C, V] result), as the JAX package asks with
`preferred_element_type=float32`: on the card
`torch.mm(..., out_dtype=torch.float32)`, on the CPU the product of the
bf16 values in fp32 (exact products, fp32 sums).  The backward recomputes
them that way; its dx and dW products stay in the hidden dtype, as the JAX
package's do.  Padded vocab columns (>= `valid_vocab`) are excluded from
the partition function with a finite -1e30 fill.

Over ranks: with `vocab_axis` (the 'model' axis) the head weight is this
rank's contiguous block of the vocabulary; a target outside it scores 0 in
this block (the kernel never meets its column; targets are not clipped into
the block), the blocks' logz merge by log-sum-exp and their target logits by
sum, and the backward sums its dx over the axis.  With `count_axis` (the 'data'
axis, or several: 'data' and 'seq') the NLL sum of this rank's rows is
divided by the target count of every rank's rows, so the global masked mean
is the sum over the axes of what each rank returns (a mean of per-rank
means would weight the ranks wrongly whenever their counts differ).

Over 'seq' ranks `hidden` is this rank's columns [c, c + S / n) of the
sequence (`col_offset` = c): the gathered loss takes the entries whose
predicting position lies in them, at local positions; the chunked loss
forms its next-token targets from the whole row's tokens and masks and
keeps its columns (`next_token_targets`), so the target of a block's last
column is the first token of the next block, not a pad.

`chunked_masked_xent(return_sum_count=True)` returns (NLL sum, target
count) undivided, neko_tpu's form for the 1F1B pipeline, which divides the
microbatches' sums by the whole batch's count.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from neko_tpu_torch.ops import loss_kernel
from neko_tpu_torch.ops.loss_kernel import _chunk_logits
from neko_tpu_torch.parallel.collectives import LOCAL, Axis, all_reduce_, mm_fp32


def merge_vocab_shards(logz: torch.Tensor, tl: torch.Tensor, axis: Axis):
    """(logz, target logit) of the whole vocabulary from each 'model' rank's
    block: the log-sum-exp of the blocks' logz, the sum of their target
    logits (a block without the target gives 0)."""
    if not axis.on:
        return logz, tl
    mx = all_reduce_(logz.clone(), axis, torch.distributed.ReduceOp.MAX)
    s = all_reduce_(torch.stack([torch.exp(logz - mx), tl]), axis)
    return mx + torch.log(s[0]), s[1]


def local_vocab(t: torch.Tensor, rows: int, valid_vocab: Optional[int], axis: Axis):
    """(targets relative to this rank's block of `rows` columns, out of
    [0, rows) when another rank's; the block's valid column count
    clamp(valid - r * rows, 0, rows))."""
    off = axis.index * rows
    valid = rows if valid_vocab is None else max(0, min(rows, valid_vocab - off))
    return t - off, valid


class _ChunkNLL(torch.autograd.Function):
    """sum over rows with m > 0 of logz - logit[target]; x [N, D], t [N]
    (global ids, in the valid vocabulary), m [N] fp32, W [V_local, D] in x's
    dtype: this rank's block of the vocabulary over `vocab_axis` (all of it
    on one device).  The forward merges the blocks' (logz, target logit);
    the backward's dW is this block's and its dx the sum over the axis of
    the blocks' fp32 partial products, rounded once."""

    @staticmethod
    def forward(ctx, x, t, m, W, valid_vocab, vocab_axis=LOCAL):
        t, valid = local_vocab(t, W.shape[0], valid_vocab, vocab_axis)
        if x.dtype == W.dtype and loss_kernel.fused_supported(*x.shape, W.shape[0], x.dtype):
            logz, tl = loss_kernel.fused_logz_tl(x, t, W, valid)
        else:
            logz, tl = loss_kernel.logits_logz_tl(x, t, W, valid)
        logz, tl = merge_vocab_shards(logz, tl, vocab_axis)
        ctx.save_for_backward(x, t, m, W, logz)
        ctx.valid_vocab, ctx.vocab_axis = valid, vocab_axis
        return torch.where(m > 0, logz - tl, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        x, t, m, W, logz = ctx.saved_tensors
        p = torch.exp(_chunk_logits(x, W, ctx.valid_vocab) - logz[:, None])
        # - onehot, for the targets in this block (no host sync)
        mine = ((t >= 0) & (t < W.shape[0])).to(p.dtype)
        p.scatter_add_(1, t.clamp(0, W.shape[0] - 1)[:, None], -mine[:, None])
        dlogits = (p * (m * g)[:, None]).to(x.dtype)
        if ctx.vocab_axis.on:
            dx = all_reduce_(mm_fp32(dlogits, W), ctx.vocab_axis).to(x.dtype)
        else:
            dx = torch.matmul(dlogits, W)
        dW = torch.matmul(dlogits.t(), x).to(W.dtype)
        return dx, None, None, dW, None, None


def _clip_targets(t: torch.Tensor, valid_vocab: int) -> torch.Tensor:
    """Masked positions may hold ids outside the scored vocabulary
    (separator, padding): clip for the gather; their mask zeroes them."""
    return t.long().clamp(0, valid_vocab - 1)


def _vocab(weight: torch.Tensor, valid_vocab: Optional[int], axis: Axis) -> int:
    V = weight.shape[0] * axis.size
    return V if valid_vocab is None else min(V, valid_vocab)


Axes = Union[Axis, Sequence[Axis]]


def _count(mask: torch.Tensor, axes: Axes) -> torch.Tensor:
    """The loss's target count summed over `axes` (the global batch's)."""
    n = mask.sum()
    for ax in (axes,) if isinstance(axes, Axis) else axes:
        if ax.on:
            n = all_reduce_(n.reshape(1).clone(), ax)[0]
    return n.clamp(min=1.0)


def next_token_targets(tokens: torch.Tensor, input_mask: torch.Tensor,
                       target_mask: torch.Tensor, col_offset: int = 0,
                       cols: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(target token, fp32 mask) of columns [col_offset, col_offset + cols)
    from the whole rows: position t predicts token t + 1, masked by
    input_mask[t] * target_mask[t + 1] (the last column of the row has no
    target)."""
    S = tokens.shape[1]
    cols = S - col_offset if cols is None else cols
    tgt = F.pad(tokens[:, 1:], (0, 1))
    mask = input_mask.float() * F.pad(target_mask[:, 1:], (0, 1)).float()
    sl = slice(col_offset, col_offset + cols)
    return tgt[:, sl], mask[:, sl]


def gathered_masked_xent(
    hidden: torch.Tensor,    # [B, S, D]
    weight: torch.Tensor,    # [V, D] head weight (this rank's block over vocab_axis)
    loss_pos: torch.Tensor,  # int [Nt, 2] (batch_row, predicting position)
    loss_tgt: torch.Tensor,  # int [Nt]
    valid_vocab: Optional[int] = None,
    chunk_size: int = 4096,
    vocab_axis: Axis = LOCAL,
    count_axis: Axes = LOCAL,
    col_offset: int = 0,
) -> torch.Tensor:
    """Mean NLL over the gathered targets; entries with batch_row == B are
    padding and carry no weight.  Over ranks: the head's vocabulary split
    over `vocab_axis`, and the sum of this rank's rows divided by the target
    count of every rank on `count_axis` (the global mean is the sum over
    those axes of what each rank returns).  `hidden` holds the sequence's
    columns [col_offset, col_offset + S): only the entries predicted there
    count here."""
    B, S = hidden.shape[:2]
    W = weight.to(hidden.dtype)
    rows = loss_pos[:, 0].long()
    pos = loss_pos[:, 1].long() - col_offset
    valid = ((rows < B) & (pos >= 0) & (pos < S)).float()
    h = hidden[rows.clamp(max=B - 1), pos.clamp(0, S - 1)]
    tgt = _clip_targets(loss_tgt, _vocab(W, valid_vocab, vocab_axis))
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, h.shape[0], chunk_size):
        sl = slice(i, i + chunk_size)
        total = total + _ChunkNLL.apply(h[sl], tgt[sl], valid[sl], W, valid_vocab, vocab_axis)
    return total / _count(valid, count_axis)


def chunked_masked_xent(
    hidden: torch.Tensor,       # [B, S, D]
    weight: torch.Tensor,       # [V, D] head weight (this rank's block over vocab_axis)
    tokens: torch.Tensor,       # int [B, S]
    input_mask: torch.Tensor,   # bool [B, S]
    target_mask: torch.Tensor,  # bool [B, S]
    valid_vocab: Optional[int] = None,
    chunk_size: int = 256,
    vocab_axis: Axis = LOCAL,
    count_axis: Axes = LOCAL,
    col_offset: int = 0,
    return_sum_count: bool = False,
):
    """Shifted next-token CE (position t predicts token t+1, masked by
    input_mask[t] * target_mask[t+1]), averaged over unmasked targets (of
    every rank on `count_axis`, as `gathered_masked_xent`).  `hidden` holds
    the columns [col_offset, col_offset + S) of the whole rows that
    `tokens` and the masks give.  With `return_sum_count`: (NLL sum, this
    call's target count), undivided."""
    B, S, D = hidden.shape
    W = weight.to(hidden.dtype)
    tgt, mask = next_token_targets(tokens, input_mask, target_mask, col_offset, S)
    tgt = _clip_targets(tgt, _vocab(W, valid_vocab, vocab_axis))
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, S, chunk_size):
        sl = slice(i, i + chunk_size)
        total = total + _ChunkNLL.apply(
            hidden[:, sl].reshape(-1, D), tgt[:, sl].reshape(-1),
            mask[:, sl].reshape(-1), W, valid_vocab, vocab_axis)
    if return_sum_count:
        return total, mask.sum()
    return total / _count(mask, count_axis)
