"""Blocked causal attention with dropout for long contexts: the Hopper kernels
and their plain versions (counterpart of neko_tpu/ops/blocked_attention.py).

Contract, as in the JAX package: causal attention over keys
`start[b] <= col < end[b]`, an fp32 softmax, the finite fill -1e30 (never
-inf).  The forward also returns the row stats m (running max of the scaled
logits) and l (softmax normalizer), fp32 [B, H, S].  Dropout multiplies the
unnormalized exp(s - m) as it enters the accumulator and l excludes the keep
mask, so the output is the dropout of the normalized probabilities.  The
backward takes (m, l) and delta = rowsum(do * o), which is computed outside
the kernels with torch ops, as the JAX package computes it in XLA.

A row that sees no key (before `start`, or start >= end) gets o = 0,
m = -1e30, l = 0, and p = 0 in the backward, so its gradients are zero and
never NaN.  The JAX kernel writes a finite average there, with l the count
of keys it visited; nothing reads those rows.

Dropout mask: the keep byte of (seed, b, h, row, col) of the whole-head
kernels (attention_kernel.py), so one seed gives one mask at every S and
every tiling: at S <= 1024 the blocked and the whole-head kernels drop the
same elements.  The JAX package's blocked mask is seeded per (b, h, q-block,
k-block) and differs from its whole-head one.

Kernels (`csrc/`, CUDA C++ for sm_90a, bound with ctypes), each counting its
launches in `<wrapper>.launches`.  Their tiles are the whole-head kernels'
(`csrc/attention_fwd.cuh`, `csrc/attention_bwd.cuh`) on the (m, l) row
stats in place of lse, plus the fused backward's dq phase:

* `blocked_attention_fwd` (TPU kernel #6 `_fwd_kernel`,
  csrc/blocked_attention.cu): writes o, m and l.
* `blocked_attention_bwd_fused` (#8 `_bwd_fused_kernel`,
  csrc/blocked_attention_bwd.cu): dq, dk and dv in one sweep over the
  (key tile, query tile) pairs, each pair's scores, probabilities and keep
  mask computed once; dq is summed across key tiles into an fp32 scratch
  with atomics and cast into dq afterwards (the JAX code casts its fused
  dk, dv outside the kernel too).
* `blocked_attention_dq` (#7 `_dq_kernel`) and `blocked_attention_dkv` (#9
  `_dkv_kernel`): the three-pass backward, no atomics.
* `dropout_keep_scale` (#10): the fp32 keep/scale matrices these kernels
  apply, which are those of kernel #5 at any S; it launches #5.

`_BlockedAttention` runs #6, then #8 for S <= FUSED_MAX, else #7 and #9.  On
a CPU tensor every wrapper runs its plain version (`blocked_*_reference`):
blocked torch code over BLOCK-wide tiles with the running (m, l, acc)
update, mirroring the JAX kernel bodies.  None of them forms a [B, H, S, S]
score tensor; the optional fp32 keep/scale [B, H, S, S] is sliced per tile.
A CUDA tensor launches the kernels or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from neko_tpu_torch.ops import attention_kernel as whk

BLOCK = 512  # the plain versions' tile (the JAX package's); the kernels tile 64 x 32
# The backward takes the fused route (#8) up to this S and the three-pass
# route (#7 + #9) beyond it.  On an H100 80GB HBM3 (700 W), bf16, rate 0.1,
# full rows, H = 24, hd = 32, 16,384 tokens (chip_smoke.py phase 7), fused /
# (dq + dkv) read about 0.7 at S = 2048, 4096, 8192 and 16384 (PERF.md §6):
# the fused route wins at every S timed, by as much at the longest, and its
# fp32 dq scratch is only the size of q in fp32.  So it has no upper bound;
# the three-pass kernels serve the checks and a caller that lowers this.
FUSED_MAX = float("inf")


def supported(S: int, hd: int) -> bool:
    """Shapes the blocked kernels take: any S (they mask the ragged tail
    tile themselves) and any hd <= 128 (the wrappers pad it to a compiled
    width, as attention_kernel.py says)."""
    return S > 0 and 0 < hd <= whk.MAX_HEAD_DIM


def row_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o), fp32 [B, H, S] contiguous, from [B, H, S, hd]
    views (blocked_attention.py:645-651 of the JAX package)."""
    return (do.float() * o.float()).sum(-1).contiguous()


# ----------------------------------------------------------- plain versions
def _tile_mask(r0, r1, c0, c1, start, end):
    """bool [B, 1, r1 - r0, c1 - c0]: col <= row and start <= col < end."""
    dev = start.device
    row = torch.arange(r0, r1, device=dev)[:, None]
    col = torch.arange(c0, c1, device=dev)[None, :]
    st = start.long()[:, None, None, None]
    en = end.long()[:, None, None, None]
    return (col <= row) & (col >= st) & (col < en)


def _key_tiles(r1: int):
    """Starts of the key tiles a query tile ending at row r1 visits: those
    at or below the diagonal."""
    return range(0, r1, BLOCK)


def _query_tiles(c0: int, S: int):
    """Starts of the query tiles that see the key tile starting at c0 (a
    multiple of BLOCK)."""
    return range(c0, S, BLOCK)


def _scores(q, k, r0, r1, c0, c1, start, end, sm_scale):
    """fp32 scaled scores of one tile, -1e30 where masked, and the mask."""
    s = torch.matmul(q[..., r0:r1, :].float(), k[..., c0:c1, :].float().transpose(-1, -2))
    ok = _tile_mask(r0, r1, c0, c1, start, end)
    return (s * sm_scale).masked_fill(~ok, whk._NEG), ok


def _tile(ks, r0, r1, c0, c1):
    return None if ks is None else ks[..., r0:r1, c0:c1]


def _online_update(m, l, acc, s, ok, v_blk, ks):
    """One key tile of the forward's running (m, l, acc) update; masked
    probabilities are exactly 0, and dropout scales the unnormalized
    probabilities after they enter l."""
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new).masked_fill(~ok, 0.0)
    l = l * alpha + p.sum(-1, keepdim=True)
    if ks is not None:
        p = p * ks
    acc = acc * alpha + torch.matmul(p.to(v_blk.dtype).float(), v_blk.float())
    return m_new, l, acc


def blocked_fwd_reference(q, k, v, start, end, sm_scale=None, keep_scale=None):
    """Plain #6 on [B, H, S, hd] views (any strides).  -> (o in q's dtype,
    m, l fp32 [B, H, S])."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    out = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    m_all = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    l_all = torch.empty_like(m_all)
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        m = torch.full((B, H, r1 - r0, 1), whk._NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, r1 - r0, hd, dtype=torch.float32, device=q.device)
        for c0 in _key_tiles(r1):
            c1 = min(c0 + BLOCK, S)
            s, ok = _scores(q, k, r0, r1, c0, c1, start, end, sm_scale)
            m, l, acc = _online_update(m, l, acc, s, ok, v[..., c0:c1, :],
                                       _tile(keep_scale, r0, r1, c0, c1))
        inv_l = torch.where(l > 0, 1.0 / l, 0.0)
        out[..., r0:r1, :] = (acc * inv_l).to(q.dtype)
        m_all[..., r0:r1] = m[..., 0]
        l_all[..., r0:r1] = l[..., 0]
    return out, m_all, l_all


def _tile_grads(q_t, do_t, v_t, s, ok, m_t, inv_l_t, delta_t, ks, sm_scale):
    """(p * keep, ds) of one tile, in q's dtype (as the JAX kernels cast
    them before their products): p = exp(s - m) / l on the visible keys."""
    p = (torch.exp(s - m_t) * inv_l_t).masked_fill(~ok, 0.0)
    dp = torch.matmul(do_t.float(), v_t.float().transpose(-1, -2))
    y = p
    if ks is not None:
        y, dp = p * ks, dp * ks
    ds = p * (dp - delta_t) * sm_scale
    return y.to(q_t.dtype), ds.to(q_t.dtype)


def _stats(m, l, delta, r0, r1):
    """[..., rows, 1] slices of m, 1 / l (0 where l = 0) and delta."""
    l_t = l[..., r0:r1, None]
    inv_l = torch.where(l_t > 0, 1.0 / l_t, 0.0)
    return m[..., r0:r1, None], inv_l, delta[..., r0:r1, None]


def _grads_at(q, k, v, do, stats, r0, r1, c0, c1, start, end, sm_scale, keep_scale):
    s, ok = _scores(q, k, r0, r1, c0, c1, start, end, sm_scale)
    m_t, inv_l, delta_t = stats
    return _tile_grads(q[..., r0:r1, :], do[..., r0:r1, :], v[..., c0:c1, :], s, ok,
                       m_t, inv_l, delta_t, _tile(keep_scale, r0, r1, c0, c1), sm_scale)


def _matmul_t(a, b):
    """a^T b in fp32 over the row dim of two [..., rows, n] tiles."""
    return torch.matmul(a.float().transpose(-1, -2), b.float())


def blocked_dq_reference(q, k, v, do, m, l, delta, start, end, sm_scale=None,
                         keep_scale=None):
    """Plain #7: dq from (m, l, delta), one query tile at a time over the key
    tiles at or below the diagonal."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    dq = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        stats = _stats(m, l, delta, r0, r1)
        acc = torch.zeros(B, H, r1 - r0, hd, dtype=torch.float32, device=q.device)
        for c0 in _key_tiles(r1):
            c1 = min(c0 + BLOCK, S)
            _, ds = _grads_at(q, k, v, do, stats, r0, r1, c0, c1, start, end, sm_scale,
                              keep_scale)
            acc += torch.matmul(ds.float(), k[..., c0:c1, :].float())
        dq[..., r0:r1, :] = acc.to(q.dtype)
    return dq


def blocked_dkv_reference(q, k, v, do, m, l, delta, start, end, sm_scale=None,
                          keep_scale=None):
    """Plain #9: (dk, dv), one key tile at a time over the query tiles at or
    below the diagonal."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    dk = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    for c0 in range(0, S, BLOCK):
        c1 = min(c0 + BLOCK, S)
        dk_acc = torch.zeros(B, H, c1 - c0, hd, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for r0 in _query_tiles(c0, S):
            r1 = min(r0 + BLOCK, S)
            y, ds = _grads_at(q, k, v, do, _stats(m, l, delta, r0, r1), r0, r1, c0, c1,
                              start, end, sm_scale, keep_scale)
            dv_acc += _matmul_t(y, do[..., r0:r1, :])
            dk_acc += _matmul_t(ds, q[..., r0:r1, :])
        dk[..., c0:c1, :] = dk_acc.to(q.dtype)
        dv[..., c0:c1, :] = dv_acc.to(q.dtype)
    return dk, dv


def blocked_bwd_fused_reference(q, k, v, do, m, l, delta, start, end, sm_scale=None,
                                keep_scale=None):
    """Plain #8: (dq, dk, dv) in one sweep, each tile's scores computed once;
    dk and dv accumulate in fp32 over the whole sequence and are cast at the
    end."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    dq = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    dk_acc = torch.zeros(B, H, S, hd, dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros_like(dk_acc)
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        stats = _stats(m, l, delta, r0, r1)
        acc = torch.zeros(B, H, r1 - r0, hd, dtype=torch.float32, device=q.device)
        for c0 in _key_tiles(r1):
            c1 = min(c0 + BLOCK, S)
            y, ds = _grads_at(q, k, v, do, stats, r0, r1, c0, c1, start, end, sm_scale,
                              keep_scale)
            dv_acc[..., c0:c1, :] += _matmul_t(y, do[..., r0:r1, :])
            dk_acc[..., c0:c1, :] += _matmul_t(ds, q[..., r0:r1, :])
            acc += torch.matmul(ds.float(), k[..., c0:c1, :].float())
        dq[..., r0:r1, :] = acc.to(q.dtype)
    return dq, dk_acc.to(q.dtype), dv_acc.to(q.dtype)


def dropout_keep_scale(seed: torch.Tensor, B: int, H: int, S: int, dropout_rate: float):
    """fp32 [B, H, S, S] keep/scale matrices the blocked kernels apply (the
    counterpart of #10): the whole-head kernels' masks, so on the card this
    launches kernel #5 (counted in `attention_kernel.dropout_keep_scale`)
    and on the CPU it runs the plain Philox."""
    return whk.dropout_keep_scale(seed, B, H, S, dropout_rate)


# ------------------------------------------------------ kernel bindings
def _check_stats(q, **stats) -> None:
    B, H, S, _ = q.shape
    for name, t in stats.items():
        if (t is None or t.shape != (B, H, S) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [{B}, {H}, {S}] on {q.device}")


def _new(q, dtype=None, zero=False):
    make = torch.zeros if zero else torch.empty
    return make(q.shape, dtype=dtype or q.dtype, device=q.device)


def _bwd_kernel_args(q, k, v, do, m, l, delta, start, end, seed, sm_scale, q_thr, **outs):
    """Checks and the argument block of the three backward kernels."""
    whk._check_kernel_args(q, k, v, start, end, seed if q_thr else None,
                           whk.bwd_head_dims(q.dtype))
    grads = {n: t for n, t in outs.items() if n != "dq_acc"}
    whk._check_like(q, dout=do, **grads)
    whk._check_aligned16(q=q, k=k, v=v, dout=do)
    _check_stats(q, m=m, l=l, delta=delta)
    return whk._kernel_args(q, k, v, start, end, seed if q_thr else None, sm_scale, q_thr,
                            dout=do, m=m, l=l, delta=delta, **outs)


def _plain_setup(q, seed, sm_scale, dropout_rate):
    """-> (sm_scale, keep threshold, fp32 keep/scale for the plain versions
    or None)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q_thr = whk._threshold(seed, dropout_rate)
    ks = whk._plain_keep_scale(q, seed, q_thr, dropout_rate) if q.device.type == "cpu" else None
    return sm_scale, q_thr, ks


def blocked_attention_fwd(q, k, v, start, end, seed=None, sm_scale=None, dropout_rate=0.0,
                          out=None):
    """Forward on [B, H, S, hd] views (hd contiguous, any other strides),
    written into `out` when given.  -> (out, m, l)."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd)
    if width != hd:
        res, m, l = blocked_attention_fwd(*whk.padded(width, q, k, v), start, end, seed,
                                          whk._scale(sm_scale, hd), dropout_rate)
        return whk._sliced_into((res,), (out,), hd)[0], m, l
    sm_scale, q_thr, ks = _plain_setup(q, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res, m, l = blocked_fwd_reference(q, k, v, start, end, sm_scale, ks)
        return (res if out is None else out.copy_(res)), m, l
    whk._check_kernel_args(q, k, v, start, end, seed if q_thr else None)
    out = _new(q) if out is None else out
    whk._check_like(q, out=out)
    B, H, S, _ = q.shape
    m = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    args = whk._kernel_args(q, k, v, start, end, seed if q_thr else None, sm_scale, q_thr,
                            o=out, m=m, l=l)
    whk._call("blocked_attention", "blocked_attention_fwd", args, q.device)
    blocked_attention_fwd.launches += 1
    return out, m, l


def _do(do):
    return do if do.stride(-1) == 1 else do.contiguous()


def blocked_attention_dq(q, k, v, do, m, l, delta, start, end, seed=None, sm_scale=None,
                         dropout_rate=0.0, dq=None):
    """Three-pass dq (#7) on [B, H, S, hd] views, into `dq` when given."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd, whk.bwd_head_dims(q.dtype))
    if width != hd:
        res = blocked_attention_dq(*whk.padded(width, q, k, v, do), m, l, delta, start, end,
                                   seed, whk._scale(sm_scale, hd), dropout_rate)
        return whk._sliced_into((res,), (dq,), hd)[0]
    sm_scale, q_thr, ks = _plain_setup(q, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res = blocked_dq_reference(q, k, v, do, m, l, delta, start, end, sm_scale, ks)
        return res if dq is None else dq.copy_(res)
    dq = _new(q) if dq is None else dq
    args = _bwd_kernel_args(q, k, v, _do(do), m, l, delta, start, end, seed, sm_scale, q_thr,
                            dq=dq)
    whk._call("blocked_attention_bwd", "blocked_attention_dq", args, q.device)
    blocked_attention_dq.launches += 1
    return dq


def blocked_attention_dkv(q, k, v, do, m, l, delta, start, end, seed=None, sm_scale=None,
                          dropout_rate=0.0, dk=None, dv=None):
    """Three-pass (dk, dv) (#9) on [B, H, S, hd] views, into `dk`, `dv` when
    given."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd, whk.bwd_head_dims(q.dtype))
    if width != hd:
        res = blocked_attention_dkv(*whk.padded(width, q, k, v, do), m, l, delta, start, end,
                                    seed, whk._scale(sm_scale, hd), dropout_rate)
        return whk._sliced_into(res, (dk, dv), hd)
    sm_scale, q_thr, ks = _plain_setup(q, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res = blocked_dkv_reference(q, k, v, do, m, l, delta, start, end, sm_scale, ks)
        return tuple(g if buf is None else buf.copy_(g) for g, buf in zip(res, (dk, dv)))
    dk = _new(q) if dk is None else dk
    dv = _new(q) if dv is None else dv
    args = _bwd_kernel_args(q, k, v, _do(do), m, l, delta, start, end, seed, sm_scale, q_thr,
                            dk=dk, dv=dv)
    whk._call("blocked_attention_bwd", "blocked_attention_dkv", args, q.device)
    blocked_attention_dkv.launches += 1
    return dk, dv


def blocked_attention_bwd_fused(q, k, v, do, m, l, delta, start, end, seed=None,
                                sm_scale=None, dropout_rate=0.0, dq=None, dk=None, dv=None):
    """Fused (dq, dk, dv) (#8) on [B, H, S, hd] views, into the given
    buffers.  On the card dq is summed in a zeroed fp32 [B, H, S, hd]
    scratch with atomics, in an order that changes from run to run, and
    cast into dq after the launch."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd, whk.bwd_head_dims(q.dtype))
    if width != hd:
        res = blocked_attention_bwd_fused(*whk.padded(width, q, k, v, do), m, l, delta, start,
                                          end, seed, whk._scale(sm_scale, hd), dropout_rate)
        return whk._sliced_into(res, (dq, dk, dv), hd)
    sm_scale, q_thr, ks = _plain_setup(q, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res = blocked_bwd_fused_reference(q, k, v, do, m, l, delta, start, end, sm_scale, ks)
        return tuple(g if buf is None else buf.copy_(g) for g, buf in zip(res, (dq, dk, dv)))
    dq = _new(q) if dq is None else dq
    dk = _new(q) if dk is None else dk
    dv = _new(q) if dv is None else dv
    dq_acc = _new(q, torch.float32, zero=True)
    args = _bwd_kernel_args(q, k, v, _do(do), m, l, delta, start, end, seed, sm_scale, q_thr,
                            dq=dq, dk=dk, dv=dv, dq_acc=dq_acc)
    whk._call("blocked_attention_bwd", "blocked_attention_bwd_fused", args, q.device)
    blocked_attention_bwd_fused.launches += 1
    return dq.copy_(dq_acc), dk, dv


for _fn in (blocked_attention_fwd, blocked_attention_dq, blocked_attention_dkv,
            blocked_attention_bwd_fused):
    _fn.launches = 0


# ------------------------------------------------------------- autograd
def blocked_backward(q, k, v, o, do, m, l, start, end, seed, sm_scale, dropout_rate,
                     dq, dk, dv) -> None:
    """delta outside the kernels, then the fused route for S <= FUSED_MAX,
    else the three-pass one, into the dq, dk, dv views."""
    delta = row_delta(do, o)
    rest = (start, end, seed, sm_scale, dropout_rate)
    if q.shape[2] <= FUSED_MAX:
        blocked_attention_bwd_fused(q, k, v, do, m, l, delta, *rest, dq=dq, dk=dk, dv=dv)
    else:
        blocked_attention_dq(q, k, v, do, m, l, delta, *rest, dq=dq)
        blocked_attention_dkv(q, k, v, do, m, l, delta, *rest, dk=dk, dv=dv)


class _BlockedAttention(torch.autograd.Function):
    """One autograd node for the head-packed layouts; `srcs` are (q, k, v)
    ("bsd") or (qkv,) ("qkv")."""

    @staticmethod
    def forward(ctx, layout, heads, sm_scale, rate, start, end, seed, *srcs):
        q, k, v = whk._qkv_views(layout, srcs, heads)
        B, H, S, hd = q.shape
        out = q.new_empty(B, S, H * hd)
        _, m, l = blocked_attention_fwd(q, k, v, start, end, seed, sm_scale, rate,
                                        out=whk._out_view(layout, out, heads))
        if any(ctx.needs_input_grad[7:]):
            ctx.save_for_backward(start, end, seed, out, m, l, *srcs)
            ctx.static = (layout, heads, sm_scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        start, end, seed, out, m, l, *srcs = ctx.saved_tensors
        layout, heads, sm_scale, rate = ctx.static
        grads = [torch.empty(s.shape, dtype=s.dtype, device=s.device) for s in srcs]
        blocked_backward(*whk._qkv_views(layout, srcs, heads), whk._out_view(layout, out, heads),
                         whk._out_view(layout, dout, heads), m, l, start, end, seed, sm_scale,
                         rate, *whk._qkv_views(layout, grads, heads))
        return (None,) * 7 + tuple(grads)


def blocked_attention_bsd(q, k, v, start, end, seed=None, *, heads, sm_scale=None,
                          dropout_rate=0.0):
    """Head-packed blocked attention (the JAX signature): q, k, v and the
    result are [B, S, H*hd] (any row stride)."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // heads) ** -0.5
    return _BlockedAttention.apply("bsd", heads, sm_scale, dropout_rate,
                                   start, end, seed, q, k, v)


def blocked_attention_qkv(qkv, start, end, seed=None, *, heads, sm_scale=None,
                          dropout_rate=0.0):
    """`blocked_attention_bsd` of the three column slices of one
    [B, S, 3*H*hd] projection output; returns [B, S, H*hd], and its backward
    one [B, S, 3*H*hd] gradient (no concatenation copy)."""
    if sm_scale is None:
        sm_scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    return _BlockedAttention.apply("qkv", heads, sm_scale, dropout_rate,
                                   start, end, seed, qkv)
