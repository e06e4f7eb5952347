"""The collectives of the port's process grid, and the autograd regions
built on them (the port's counterpart of what GSPMD emits for neko_tpu's
shardings: neko_tpu/parallel/sharding.py has no hand-written collective).

An `Axis` is one axis of the ('data', 'seq', 'model') grid as this rank sees
it: its size, this rank's coordinate on it and the process group of the
ranks that differ from this one only there.  Size 1 is the trivial axis
(`LOCAL`): every function here is then the identity and runs no collective.

* `all_reduce_`, `all_gather_cat`, `reduce_scatter_cat`: the three
  collectives, on tensors of any device.
* `column_parallel` / `row_parallel`: the Megatron pair, each a product
  with its all-reduce over 'model'.  A column-parallel product (the weight's
  output rows split) takes a replicated input, and each rank's gradient of
  it covers its own columns: the backward sums it over 'model'.  A
  row-parallel product (the input dim split) leaves each rank a partial
  sum: the forward sums it.  Either sum runs in fp32 on fp32 partial
  products of the low-precision operands (cuBLAS's `out_dtype` on the
  card) and is rounded once, as one process's one product rounds; the
  other products are those of one process.
* `reduce_from_model`: an all-reduce forward in fp32, the identity
  backward.
* `gather_logits`: the inference-time gather of the head's vocabulary
  blocks over 'model' (no autograd): every rank gets the same bits.
* `vocab_parallel_embedding`: the lookup in this rank's rows of a table
  split over 'model' (rows outside the shard give zero), then
  `reduce_from_model`.
* `gather_shard`: FSDP's use-site gather, an all-gather over 'data' along
  the sharded dim forward and a reduce-scatter of the gradient backward (the
  sum over the data ranks, this rank's block kept).
* `all_reduce_grads_`: a gradient sum over an axis in flat buckets (over
  'data' of the leaves not split there; over 'model' of the leaves
  replicated there, whose copies `TrainContext.sync_grads` averages).
* `exchange`: point-to-point sends and receives between the ranks of a
  group (the ring's kv hops over 'seq', the pipeline's activation and
  gradient hops over 'pipe'), posted together in one `batch_isend_irecv`.

The backend's own route carries them: NCCL (a card for each rank) on the
card, gloo (the CPU, or several ranks sharing one card, where NCCL refuses
two ranks on one card) through host memory, which gloo does itself for a
CUDA tensor (every collective used here runs on CUDA tensors under gloo:
probed on one H100, see PERF.md §6).  Point-to-point is another matter:
gloo's send and recv take host memory only, so under a gloo group
`exchange` stages the CUDA tensors it moves through pinned host buffers
(a copy to the host before a send, from the host after a receive); under
NCCL they move directly.  That is the transport alone: the compute stays
on the card.

`stats` counts the calls and the bytes each rank sends into collectives
and point-to-point sends;
with `stats.timed` it also sums their wall time, synchronising the card
around each one (a measurement mode: off on the train path).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the process grid as this rank sees it."""

    size: int = 1
    index: int = 0
    group: Any = None

    @property
    def on(self) -> bool:
        return self.size > 1


LOCAL = Axis()


@dataclasses.dataclass
class Stats:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


stats = Stats()


class _Timed:
    def __init__(self, t: torch.Tensor):
        self.t = t

    def __enter__(self):
        stats.calls += 1
        stats.bytes += self.t.numel() * self.t.element_size()
        if stats.timed:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if stats.timed and exc[0] is None:
            if self.t.is_cuda:
                torch.cuda.synchronize(self.t.device)
            stats.seconds += time.perf_counter() - self.t0


def all_reduce_(t: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`t` reduced over the axis, in place (t contiguous).  -> t."""
    if not axis.on:
        return t
    with _Timed(t):
        dist.all_reduce(t, op=op, group=axis.group)
    return t


def all_gather_cat(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The axis' blocks of `t` concatenated along `dim`, in coordinate
    order (every rank's `t` has the same shape)."""
    if not axis.on:
        return t
    t = t.contiguous()
    with _Timed(t):
        parts = [torch.empty_like(t) for _ in range(axis.size)]
        dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim)


def reduce_scatter_cat(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """The sum of `t` over the axis, cut into `size` blocks along `dim`:
    this rank's block (the inverse of `all_gather_cat`'s layout)."""
    if not axis.on:
        return t
    n = t.shape[dim] // axis.size
    t = t.contiguous()
    with _Timed(t):
        chunks = [c.contiguous() for c in t.split(n, dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=axis.group)
    return out


def mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] with fp32 sums and an fp32 result: on the card
    cuBLAS's `out_dtype` for low-precision operands, on the CPU the exact
    products in fp32."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ColumnParallel(torch.autograd.Function):
    """y = x @ w^T + b in x's dtype; dx summed over the axis."""

    @staticmethod
    def forward(ctx, x, w, b, axis):
        ctx.save_for_backward(x, w)
        ctx.axis, ctx.bias = axis, b is not None
        return torch.nn.functional.linear(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
        dx = all_reduce_(mm_fp32(g2, w), ctx.axis).to(x.dtype).reshape(x.shape)
        return dx, g2.t() @ x2, g2.sum(0) if ctx.bias else None, None


class _RowParallel(torch.autograd.Function):
    """fp32 x @ w^T summed over the axis (x's last dim and w's columns are
    this rank's block)."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.save_for_backward(x, w)
        part = mm_fp32(x.reshape(-1, x.shape[-1]), w.t())
        return all_reduce_(part, axis).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.to(x.dtype).reshape(-1, g.shape[-1])
        dx = (g2 @ w).reshape(x.shape)
        return dx, g2.t() @ x.reshape(-1, x.shape[-1]), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.dtype = x.dtype
        return all_reduce_(x.float().contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_cat(shard.detach(), dim, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_cat(g, ctx.dim, ctx.axis), None, None


def column_parallel(x: torch.Tensor, w: torch.Tensor, b, axis: Axis) -> torch.Tensor:
    """x @ w^T + b for a weight whose output rows are this rank's block
    (x replicated over the axis; its gradient summed over it)."""
    if not axis.on:
        return torch.nn.functional.linear(x, w, b)
    return _ColumnParallel.apply(x, w, b, axis)


def row_parallel(x: torch.Tensor, w: torch.Tensor, axis: Axis) -> torch.Tensor:
    """fp32 x @ w^T for a weight whose input columns are this rank's block
    (x this rank's block of the features), summed over the axis."""
    return _RowParallel.apply(x, w, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The fp32 sum of `x` over the axis (its gradient passes unchanged)."""
    return _ReduceFromModel.apply(x, axis) if axis.on else x.float()


def gather_shard(shard: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    return _GatherShard.apply(shard, dim, axis) if axis.on else shard


def gather_logits(logits: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The blocks of the vocabulary (last dim) of every rank over the axis,
    concatenated in coordinate order: the whole logits on every rank
    (inference: no gradient flows through it)."""
    return all_gather_cat(logits, logits.dim() - 1, axis)


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rows `ids` of a table whose rows are split over the axis in contiguous
    blocks (`weight` is this rank's block) -> fp32 [..., D]."""
    if not axis.on:
        return torch.nn.functional.embedding(ids, weight).float()
    rows = weight.shape[0]
    local = ids - axis.index * rows
    inside = (local >= 0) & (local < rows)
    e = torch.nn.functional.embedding(local.clamp(0, rows - 1), weight)
    return reduce_from_model(torch.where(inside[..., None], e, 0.0), axis)


def all_reduce_grads_(grads: Sequence[torch.Tensor], axis: Axis,
                      bucket_elems: int = 1 << 24) -> None:
    """Sum each gradient over the axis in place, packed into flat buckets of
    at most `bucket_elems` elements per dtype and device."""
    if not axis.on:
        return
    by_kind: dict = {}
    for g in grads:
        by_kind.setdefault((g.dtype, g.device), []).append(g)
    for gs in by_kind.values():
        bucket: List[torch.Tensor] = []
        n = 0
        for g in gs + [None]:
            if g is None or (bucket and n + g.numel() > bucket_elems):
                flat = all_reduce_(torch.cat([b.reshape(-1) for b in bucket]), axis)
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, n = [], 0
            if g is not None:
                bucket.append(g)
                n += g.numel()


class _Exchange:
    """The requests of one `exchange`: `wait()` waits for them all, then
    copies what arrived in host buffers to the receiving device tensors."""

    def __init__(self, works, staged):
        self.works, self.staged = works, staged

    def wait(self) -> None:
        for w in self.works:
            w.wait()
        for dst, host in self.staged:
            dst.copy_(host)
        self.works, self.staged = [], []


def exchange(ops, group) -> _Exchange:
    """Post the point-to-point `ops` of this rank, (dist.isend or
    dist.irecv, tensor, peer's rank in `group`, tag), in one
    `batch_isend_irecv`, and return what to `wait()` on.  Every rank lists
    its ops in one order (the sends and receives a pair of ranks exchange
    must match in order and tag).  Under a gloo group the CUDA tensors go
    through pinned host buffers (gloo's point-to-point moves host memory
    only); under NCCL they move as they are.  With `stats.timed` the
    transfer completes here, timed between synchronisations of the card."""
    staged_group = dist.get_backend(group) == "gloo"
    p2p, staged = [], []
    cuda = [t for _, t, _, _ in ops if t.is_cuda]
    if stats.timed and cuda:
        torch.cuda.synchronize(cuda[0].device)
    t0 = time.perf_counter()
    for op, t, peer, tag in ops:
        buf = t
        if op is dist.isend:
            stats.calls += 1
            stats.bytes += t.numel() * t.element_size()
        if staged_group and t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if op is dist.isend:
                buf.copy_(t)
            else:
                staged.append((t, buf))
        p2p.append(dist.P2POp(op, buf, dist.get_global_rank(group, peer), group, tag))
    req = _Exchange(dist.batch_isend_irecv(p2p) if p2p else [], staged)
    if stats.timed:
        req.wait()
        if cuda:
            torch.cuda.synchronize(cuda[0].device)
        stats.seconds += time.perf_counter() - t0
    return req
