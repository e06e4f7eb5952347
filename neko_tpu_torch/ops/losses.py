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
The head matmuls stay cuBLAS products in the hidden dtype: the JAX package
computes them in XLA, outside any Pallas kernel.  The logits come out in
fp32 from bf16 operands (fp32 sums, no bf16 rounding of the [C, V] result),
as the JAX package asks with `preferred_element_type=float32`: on the card
`torch.mm(..., out_dtype=torch.float32)`, on the CPU the product of the
bf16 values in fp32 (exact products, fp32 sums).  The backward's dx and dW
products stay in the hidden dtype, as the JAX package's do.  So does the
forward's (logz, target logit), the JAX package's `_logz_tl`: logits, then
torch's logsumexp and gather.  The fused loss-head kernel #15
(`ops/loss_kernel.py`, no [C, V] logits) is a check kernel, as its Pallas
counterpart is in the JAX package, whose loss never dispatches it.  Padded
vocab columns (>= `valid_vocab`) are excluded from the partition function
with a finite -1e30 fill.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30


def _chunk_logits(x, W, valid_vocab):
    """fp32 [C, V] logits of x [C, D] against W [V, D] (both in the hidden
    dtype), masked past `valid_vocab`."""
    if x.dtype == torch.float32:
        logits = F.linear(x, W)
    elif x.is_cuda:
        logits = torch.mm(x, W.t(), out_dtype=torch.float32)
    else:
        logits = F.linear(x.float(), W.float())
    if valid_vocab is not None and valid_vocab < W.shape[0]:
        col = torch.arange(W.shape[0], device=x.device)
        logits = logits.masked_fill(col >= valid_vocab, _NEG)
    return logits


class _ChunkNLL(torch.autograd.Function):
    """sum over rows with m > 0 of logz - logit[target]; x [N, D], t [N]
    (in range), m [N] fp32, W [V, D] in x's dtype."""

    @staticmethod
    def forward(ctx, x, t, m, W, valid_vocab):
        logits = _chunk_logits(x, W, valid_vocab)
        logz = torch.logsumexp(logits, dim=-1)
        tl = logits.gather(1, t[:, None])[:, 0]
        ctx.save_for_backward(x, t, m, W, logz)
        ctx.valid_vocab = valid_vocab
        return torch.where(m > 0, logz - tl, 0.0).sum()

    @staticmethod
    def backward(ctx, g):
        x, t, m, W, logz = ctx.saved_tensors
        p = torch.exp(_chunk_logits(x, W, ctx.valid_vocab) - logz[:, None])
        p[torch.arange(p.shape[0], device=p.device), t] -= 1.0  # - onehot
        dlogits = (p * (m * g)[:, None]).to(x.dtype)
        dx = torch.matmul(dlogits, W)
        dW = torch.matmul(dlogits.t(), x).to(W.dtype)
        return dx, None, None, dW, None


def _clip_targets(t: torch.Tensor, V: int, valid_vocab: Optional[int]) -> torch.Tensor:
    """Masked positions may hold ids outside the scored vocabulary
    (separator, padding): clip for the gather; their mask zeroes them."""
    hi = V if valid_vocab is None else min(V, valid_vocab)
    return t.long().clamp(0, hi - 1)


def gathered_masked_xent(
    hidden: torch.Tensor,    # [B, S, D]
    weight: torch.Tensor,    # [V, D] head weight
    loss_pos: torch.Tensor,  # int [Nt, 2] (batch_row, predicting position)
    loss_tgt: torch.Tensor,  # int [Nt]
    valid_vocab: Optional[int] = None,
    chunk_size: int = 4096,
) -> torch.Tensor:
    """Mean NLL over the gathered targets; entries with batch_row == B are
    padding and carry no weight."""
    B = hidden.shape[0]
    W = weight.to(hidden.dtype)
    rows = loss_pos[:, 0].long()
    valid = (rows < B).float()
    h = hidden[rows.clamp(max=B - 1), loss_pos[:, 1].long()]  # [Nt, D]
    tgt = _clip_targets(loss_tgt, W.shape[0], valid_vocab)
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, h.shape[0], chunk_size):
        sl = slice(i, i + chunk_size)
        total = total + _ChunkNLL.apply(h[sl], tgt[sl], valid[sl], W, valid_vocab)
    return total / valid.sum().clamp(min=1.0)


def chunked_masked_xent(
    hidden: torch.Tensor,       # [B, S, D]
    weight: torch.Tensor,       # [V, D] head weight
    tokens: torch.Tensor,       # int [B, S]
    input_mask: torch.Tensor,   # bool [B, S]
    target_mask: torch.Tensor,  # bool [B, S]
    valid_vocab: Optional[int] = None,
    chunk_size: int = 256,
) -> torch.Tensor:
    """Shifted next-token CE (position t predicts token t+1, masked by
    input_mask[t] * target_mask[t+1]), averaged over unmasked targets."""
    B, S, D = hidden.shape
    W = weight.to(hidden.dtype)
    tgt = _clip_targets(F.pad(tokens[:, 1:], (0, 1)), W.shape[0], valid_vocab)
    mask = input_mask.float() * F.pad(target_mask[:, 1:], (0, 1)).float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, S, chunk_size):
        sl = slice(i, i + chunk_size)
        total = total + _ChunkNLL.apply(
            hidden[:, sl].reshape(-1, D), tgt[:, sl].reshape(-1),
            mask[:, sl].reshape(-1), W, valid_vocab)
    return total / mask.sum().clamp(min=1.0)
