"""Ring attention with hand-written per-pair kernels: sequence parallelism for
long contexts (counterpart of neko_tpu/ops/ring_kernel.py).

The sequence is cut into n shards of S_local rows along the mesh's 'seq'
axis.  Shard i owns the q, k, v rows [i * S_local, (i + 1) * S_local).  A
pass takes n steps; at step t shard i meets the kv block of shard
(i - t) mod n.  Per (local q block, visiting kv block) pair a kernel computes
the pair's partial from the two GLOBAL offsets:

* forward (`ring_partial_fwd`, TPU kernel #11 `_ring_fwd_kernel`): the fp32
  accumulator acc = sum_c exp(s - m) * keep * v, NOT divided by l, with the
  pair's row max m and row sum l.  Torch ops merge (m, l, acc) across the
  steps (the two-level online softmax: `merge_partial`), and at the end
  out = acc / l and the log-sum-exp L = m + log(l).
* backward, a second ring pass from L and delta = rowsum(do * out) (computed
  outside the kernels): `ring_partial_dq` (#12 `_ring_dq_kernel`), the dq of
  the local rows from this kv block, summed locally; `ring_partial_dkv` (#13
  `_ring_dkv_kernel`), the dk, dv of the VISITING block from the local rows,
  summed in accumulators that travel with the kv block and are home after n
  hops.  Partials and sums are fp32; the gradients are cast once at the end.

Causal masking, the key window [start, end) (global bounds, computed once
from the key mask: nothing mask-shaped travels) and the dropout keep mask all
take global rows and columns.  The keep byte of (seed, b, h, row, col) is the
one every attention kernel of the port draws (attention_kernel.py), so one
seed drops the same elements through the ring as through the blocked kernels
at the same S, whichever step computes a pair.  (The JAX package seeds its
ring mask per global 512-block, which differs from its blocked one.)

A kv block wholly in the future of the q block (k_off > q_off + S_local - 1)
contributes nothing.  The JAX kernel is launched for it with a zero trip
count; here the offsets are host integers and the pair is SKIPPED on the host
(`pair_visible`): a pass launches n (n + 1) / 2 pairs per kernel, not n * n.
The block still travels, so that it and its dk, dv sums get home.

Rows that see no key of a pair give m = -1e30, l = 0, acc = 0, and p = 0 in
the backward; merging such a partial changes nothing, and a row that sees no
key in the whole ring comes out as 0 with L = 0, never NaN.

Two thin schedules run the same per-pair step (`_fwd_step`, `_bwd_step`):

* shards on one device (`group=None`): q, k, v are the global [B, S, H*hd]
  tensors and the schedule walks (shard i, step t) over views of them (the
  kernels take strides: no copies);
* shards on the ranks of a process group: q, k, v are this rank's blocks
  [B, S_local, H*hd], and k, v (and in the backward their dk, dv sums) go to
  rank + 1 with `torch.distributed.batch_isend_irecv` (`collectives.exchange`),
  the counterpart of the JAX package's `ppermute`s.  The kv transfer of the
  next step is in flight while this step's pair is computed.  Under a gloo
  group (ranks sharing one card) the blocks travel through pinned host
  buffers, gloo's point-to-point taking host memory only.

Kernels: `csrc/ring_attention.cu` (CUDA C++ for sm_90a, bound with ctypes),
the tiles of `csrc/attention_fwd.cuh` / `csrc/attention_bwd.cuh` in their
ring mode.  Each wrapper counts its launches in `<wrapper>.launches`.  On a
CPU tensor a wrapper runs its plain version (`ring_partial_*_reference`:
blocked torch code over BLOCK-wide tiles with global offsets, no
[B, H, S, S] tensor).  A CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from neko_tpu_torch.ops import attention_kernel as whk
from neko_tpu_torch.ops import blocked_attention as ba
from neko_tpu_torch.parallel.collectives import exchange

BLOCK = ba.BLOCK  # the plain versions' tile; the bf16 kernels tile 64 x 64
# profiler range around the torch passes between the kernels (the merges of
# (m, l, acc), out = acc / l and L, the adds of the gradient partials)
MERGE_RANGE = "ring merge"


def supported(S_local: int, hd: int) -> bool:
    """Shapes the ring kernels take: any S_local and any hd <= 128 (the
    wrappers pad it to a compiled width, as attention_kernel.py says).  (The
    JAX package's `S_local <= 8192`, `% 128` and head-group gates are limits
    of the TPU's memory and lanes.)"""
    return S_local > 0 and 0 < hd <= whk.MAX_HEAD_DIM


def pair_visible(q_off: int, k_off: int, S_local: int) -> bool:
    """Whether any row of the q block at `q_off` can see a key of the kv block
    at `k_off` under the causal mask."""
    return k_off <= q_off + S_local - 1


# ----------------------------------------------------------- plain versions
def _pair_scores(q, k, r0, r1, c0, c1, q_off, k_off, start, end, sm_scale):
    """fp32 scaled scores of one tile (local rows [r0, r1), local keys
    [c0, c1)), -1e30 where the global mask hides them, and the mask."""
    s = torch.matmul(q[..., r0:r1, :].float(), k[..., c0:c1, :].float().transpose(-1, -2))
    ok = ba._tile_mask(q_off + r0, q_off + r1, k_off + c0, k_off + c1, start, end)
    return (s * sm_scale).masked_fill(~ok, whk._NEG), ok


def _key_tiles(r1_global: int, k_off: int, S: int):
    """Local starts of the key tiles of the block at `k_off` that a query
    tile ending at global row `r1_global` visits: those at or below its
    diagonal."""
    return range(0, min(S, r1_global - k_off), BLOCK)


def ring_partial_fwd_reference(q, k, v, q_off, k_off, start, end, sm_scale=None,
                               keep_scale=None):
    """Plain #11 on [B, H, S_local, hd] views.  `keep_scale`: the pair's
    fp32 [B, H, S_local, S_local] window of the keep/scale matrices.
    -> (acc fp32 [B, H, S_local, hd], not divided by l; m, l fp32
    [B, H, S_local])."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    acc_all = torch.empty(B, H, S, hd, dtype=torch.float32, device=q.device)
    m_all = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    l_all = torch.empty_like(m_all)
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        m = torch.full((B, H, r1 - r0, 1), whk._NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, r1 - r0, hd, dtype=torch.float32, device=q.device)
        for c0 in _key_tiles(q_off + r1, k_off, S):
            c1 = min(c0 + BLOCK, S)
            s, ok = _pair_scores(q, k, r0, r1, c0, c1, q_off, k_off, start, end, sm_scale)
            m, l, acc = ba._online_update(m, l, acc, s, ok, v[..., c0:c1, :],
                                          ba._tile(keep_scale, r0, r1, c0, c1))
        acc_all[..., r0:r1, :] = acc
        m_all[..., r0:r1] = m[..., 0]
        l_all[..., r0:r1] = l[..., 0]
    return acc_all, m_all, l_all


def _pair_grads(q, k, v, do, L, delta, r0, r1, c0, c1, q_off, k_off, start, end, sm_scale,
                keep_scale):
    """(p * keep, ds) of one tile in q's dtype, with p = exp(s - L) on the
    visible keys and 0 elsewhere."""
    s, ok = _pair_scores(q, k, r0, r1, c0, c1, q_off, k_off, start, end, sm_scale)
    return ba._tile_grads(q[..., r0:r1, :], do[..., r0:r1, :], v[..., c0:c1, :], s, ok,
                          L[..., r0:r1, None], 1.0, delta[..., r0:r1, None],
                          ba._tile(keep_scale, r0, r1, c0, c1), sm_scale)


def ring_partial_dq_reference(q, k, v, do, L, delta, q_off, k_off, start, end, sm_scale=None,
                              keep_scale=None):
    """Plain #12: the fp32 dq partial of the local rows from one kv block."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    dq = torch.zeros(B, H, S, hd, dtype=torch.float32, device=q.device)
    for r0 in range(0, S, BLOCK):
        r1 = min(r0 + BLOCK, S)
        for c0 in _key_tiles(q_off + r1, k_off, S):
            c1 = min(c0 + BLOCK, S)
            _, ds = _pair_grads(q, k, v, do, L, delta, r0, r1, c0, c1, q_off, k_off, start, end,
                                sm_scale, keep_scale)
            dq[..., r0:r1, :] += torch.matmul(ds.float(), k[..., c0:c1, :].float())
    return dq


def ring_partial_dkv_reference(q, k, v, do, L, delta, q_off, k_off, start, end, sm_scale=None,
                               keep_scale=None):
    """Plain #13: the fp32 (dk, dv) partials of the VISITING kv block from
    the local rows (the query tiles at or after each key tile's global
    offset)."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    dk = torch.zeros(B, H, S, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, S, BLOCK):
        c1 = min(c0 + BLOCK, S)
        for r0 in range(0, S, BLOCK):
            r1 = min(r0 + BLOCK, S)
            if q_off + r1 - 1 < k_off + c0:
                continue  # the key tile lies in the future of every row of the tile
            y, ds = _pair_grads(q, k, v, do, L, delta, r0, r1, c0, c1, q_off, k_off, start, end,
                                sm_scale, keep_scale)
            dv[..., c0:c1, :] += ba._matmul_t(y, do[..., r0:r1, :])
            dk[..., c0:c1, :] += ba._matmul_t(ds, q[..., r0:r1, :])
    return dk, dv


# ------------------------------------------------------ kernel bindings
def _pair_setup(q, q_off, k_off, seed, sm_scale, dropout_rate):
    """-> (sm_scale, keep threshold, the pair's fp32 keep/scale window for
    the plain versions or None)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q_thr = whk._threshold(seed, dropout_rate)
    ks = None
    if q_thr and q.device.type == "cpu":
        B, H, S, _ = q.shape
        ks = whk.dropout_keep_scale_reference(seed, B, H, None, dropout_rate,
                                              rows=(q_off, q_off + S), cols=(k_off, k_off + S))
    return sm_scale, q_thr, ks


def _new_fp32(q):
    """A new fp32 [B, H, S_local, hd] view in the head-packed layout."""
    B, H, S, hd = q.shape
    return whk._heads4(torch.empty(B, S, H * hd, dtype=torch.float32, device=q.device), H)


def _new_stat(q):
    B, H, S, _ = q.shape
    return torch.empty(B, H, S, dtype=torch.float32, device=q.device)


def _new_state(q):
    """New (m, l, acc) buffers of one q block: a running state or a partial."""
    return _new_stat(q), _new_stat(q), _new_fp32(q)


def _new_grads(q):
    """New fp32 (dq, dk, dv) buffers of one block pair."""
    return _new_fp32(q), _new_fp32(q), _new_fp32(q)


def _fp32_like(q, buf, name):
    """`buf`, checked, or a new fp32 [B, H, S_local, hd] view."""
    if buf is None:
        return _new_fp32(q)
    if (buf.shape != q.shape or buf.dtype != torch.float32 or buf.device != q.device
            or buf.stride(-1) != 1):
        raise ValueError(f"{name} must be fp32 {tuple(q.shape)} on {q.device} with a "
                         f"contiguous head dim, got {buf.dtype} {tuple(buf.shape)}")
    return buf


def _filled(res, bufs):
    return tuple(r if buf is None else buf.copy_(r) for r, buf in zip(res, bufs))


def ring_partial_fwd(q, k, v, q_off, k_off, start, end, seed=None, sm_scale=None,
                     dropout_rate=0.0, out=None, m=None, l=None):
    """Forward partial (#11) of the q block at global row `q_off` against the
    kv block at global column `k_off`, on [B, H, S_local, hd] views (hd
    contiguous, any other strides); `start`, `end` are the global key bounds.
    Written into the fp32 buffers `out` ([B, H, S_local, hd] view), `m`, `l`
    ([B, H, S_local] contiguous) when given.  -> (acc, m, l)."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd, whk.head_dims(q.dtype))
    if width != hd:
        acc, m_p, l_p = ring_partial_fwd(*whk.padded(width, q, k, v), q_off, k_off, start, end,
                                         seed, whk._scale(sm_scale, hd), dropout_rate)
        return (*whk._sliced_into((acc,), (out,), hd), *_filled((m_p, l_p), (m, l)))
    sm_scale, q_thr, ks = _pair_setup(q, q_off, k_off, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res = ring_partial_fwd_reference(q, k, v, q_off, k_off, start, end, sm_scale, ks)
        return _filled(res, (out, m, l))
    whk._check_kernel_args(q, k, v, start, end, seed if q_thr else None)
    whk._check_aligned16(q=q, k=k, v=v)
    out = _fp32_like(q, out, "out")
    m, l = (_new_stat(q) if t is None else t for t in (m, l))
    ba._check_stats(q, m=m, l=l)
    args = whk._kernel_args(q, k, v, start, end, seed if q_thr else None, sm_scale, q_thr,
                            q_off, k_off, o=out, m=m, l=l)
    whk._call("ring_attention", "ring_attention_fwd", args, q.device)
    ring_partial_fwd.launches += 1
    return out, m, l


def _bwd_kernel_args(q, k, v, do, L, delta, q_off, k_off, start, end, seed, sm_scale, q_thr,
                     **outs):
    whk._check_kernel_args(q, k, v, start, end, seed if q_thr else None)
    whk._check_like(q, dout=do)
    whk._check_aligned16(q=q, k=k, v=v, dout=do)
    ba._check_stats(q, L=L, delta=delta)
    return whk._kernel_args(q, k, v, start, end, seed if q_thr else None, sm_scale, q_thr,
                            q_off, k_off, dout=do, lse=L, delta=delta, **outs)


def ring_partial_dq(q, k, v, do, L, delta, q_off, k_off, start, end, seed=None, sm_scale=None,
                    dropout_rate=0.0, dq=None):
    """dq partial (#12) of the local rows from the kv block at `k_off`: fp32,
    into `dq` when given.  `L` and `delta` are fp32 [B, H, S_local]
    contiguous: the log-sum-exp of the whole ring and rowsum(do * out)."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd, whk.head_dims(q.dtype))
    if width != hd:
        res = ring_partial_dq(*whk.padded(width, q, k, v, do), L, delta, q_off, k_off, start,
                              end, seed, whk._scale(sm_scale, hd), dropout_rate)
        return whk._sliced_into((res,), (dq,), hd)[0]
    sm_scale, q_thr, ks = _pair_setup(q, q_off, k_off, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res = ring_partial_dq_reference(q, k, v, do, L, delta, q_off, k_off, start, end,
                                        sm_scale, ks)
        return res if dq is None else dq.copy_(res)
    dq = _fp32_like(q, dq, "dq")
    args = _bwd_kernel_args(q, k, v, ba._do(do), L, delta, q_off, k_off, start, end, seed,
                            sm_scale, q_thr, dq=dq)
    whk._call("ring_attention", "ring_attention_dq", args, q.device)
    ring_partial_dq.launches += 1
    return dq


def ring_partial_dkv(q, k, v, do, L, delta, q_off, k_off, start, end, seed=None, sm_scale=None,
                     dropout_rate=0.0, dk=None, dv=None):
    """(dk, dv) partials (#13) of the VISITING kv block at `k_off` from the
    local rows at `q_off`: fp32, into `dk`, `dv` when given."""
    hd = q.shape[-1]
    width = whk.kernel_head_dim(hd, whk.head_dims(q.dtype))
    if width != hd:
        res = ring_partial_dkv(*whk.padded(width, q, k, v, do), L, delta, q_off, k_off, start,
                               end, seed, whk._scale(sm_scale, hd), dropout_rate)
        return whk._sliced_into(res, (dk, dv), hd)
    sm_scale, q_thr, ks = _pair_setup(q, q_off, k_off, seed, sm_scale, dropout_rate)
    if whk._device_of(q) == "cpu":
        res = ring_partial_dkv_reference(q, k, v, do, L, delta, q_off, k_off, start, end,
                                         sm_scale, ks)
        return _filled(res, (dk, dv))
    dk, dv = _fp32_like(q, dk, "dk"), _fp32_like(q, dv, "dv")
    args = _bwd_kernel_args(q, k, v, ba._do(do), L, delta, q_off, k_off, start, end, seed,
                            sm_scale, q_thr, dk=dk, dv=dv)
    whk._call("ring_attention", "ring_attention_dkv", args, q.device)
    ring_partial_dkv.launches += 1
    return dk, dv


for _fn in (ring_partial_fwd, ring_partial_dq, ring_partial_dkv):
    _fn.launches = 0


# ------------------------------------------------------- the per-pair steps
def merge_partial(m, l, acc, m_p, l_p, acc_p) -> None:
    """Merges the partial (m_p, l_p, acc_p) of one kv block into the running
    (m, l, acc), in place: the two-level online softmax.  m, l are
    [B, H, S_local]; acc, acc_p [B, H, S_local, hd] views.  Where both maxima
    are the -1e30 fill both factors are exp(0) = 1 on l = 0 and acc = 0."""
    m_new = torch.maximum(m, m_p)
    a1, a2 = torch.exp(m - m_new), torch.exp(m_p - m_new)
    l.mul_(a1).addcmul_(l_p, a2)
    acc.mul_(a1[..., None]).addcmul_(acc_p, a2[..., None])
    m.copy_(m_new)


def _fwd_step(q, k, v, q_off, k_off, state, scratch, first, common) -> None:
    """One pair of the forward ring: the partial of the local q block against
    the visiting kv block, merged into the running `state` = (m, l, acc).
    `first`: the state holds nothing yet (the diagonal pair, which every
    row's own key makes visible) and the kernel writes straight into it."""
    if not pair_visible(q_off, k_off, q.shape[2]):
        assert not first, "a ring pass starts on the shard's own kv block"
        return
    m, l, acc = state
    if first:
        ring_partial_fwd(q, k, v, q_off, k_off, *common, out=acc, m=m, l=l)
        return
    m_p, l_p, acc_p = scratch
    ring_partial_fwd(q, k, v, q_off, k_off, *common, out=acc_p, m=m_p, l=l_p)
    with torch.profiler.record_function(MERGE_RANGE):
        merge_partial(m, l, acc, m_p, l_p, acc_p)


def _finish_fwd(state, out) -> torch.Tensor:
    """out = acc / l (0 where l = 0) into the [B, H, S_local, hd] view `out`.
    -> L = m + log(l), fp32 [B, H, S_local] (0 where l = 0)."""
    m, l, acc = state
    with torch.profiler.record_function(MERGE_RANGE):
        seen = l > 0
        out.copy_(acc * torch.where(seen, 1.0 / l.clamp_min(1e-30), 0.0)[..., None])
        return torch.where(seen, m + torch.log(l.clamp_min(1e-30)), 0.0)


def _bwd_step(q, k, v, do, L, delta, q_off, k_off, grads, scratch, first, common) -> None:
    """One pair of the backward ring: dq of the local rows and dk, dv of the
    visiting block, added into `grads` = (dq, dk, dv) (fp32 views; dk and dv
    are the sums that travel with the kv block).  `first`: the sums hold
    nothing yet and the kernels write straight into them."""
    if not pair_visible(q_off, k_off, q.shape[2]):
        assert not first, "a ring pass starts on the shard's own kv block"
        return
    dq, dk, dv = grads
    pair = (q, k, v, do, L, delta, q_off, k_off, *common)
    if first:
        ring_partial_dq(*pair, dq=dq)
        ring_partial_dkv(*pair, dk=dk, dv=dv)
        return
    dq_p, dk_p, dv_p = scratch
    ring_partial_dq(*pair, dq=dq_p)
    ring_partial_dkv(*pair, dk=dk_p, dv=dv_p)
    with torch.profiler.record_function(MERGE_RANGE):
        dq.add_(dq_p)
        dk.add_(dk_p)
        dv.add_(dv_p)


# ----------------------------------------- schedule: shards on one device
def _ring_fwd_local(q, k, v, out, n, common) -> torch.Tensor:
    """Forward ring over the n row blocks of the global [B, H, S, hd] views.
    Writes `out` (a [B, H, S, hd] view).  -> L fp32 [n, B, H, S_local]."""
    B, H, S, hd = q.shape
    S_l = S // n
    qs, ks, vs, outs = (t.chunk(n, dim=2) for t in (q, k, v, out))
    accs = _new_fp32(q).chunk(n, dim=2)
    m = torch.empty(n, B, H, S_l, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    scratch = _new_state(qs[0])  # the partials' buffers, allocated once a pass
    for t in range(n):
        for i in range(n):
            j = (i - t) % n
            _fwd_step(qs[i], ks[j], vs[j], i * S_l, j * S_l, (m[i], l[i], accs[i]), scratch,
                      t == 0, common)
    return torch.stack([_finish_fwd((m[i], l[i], accs[i]), outs[i]) for i in range(n)])


def _ring_bwd_local(q, k, v, out, do, L, grads, n, common) -> None:
    """Backward ring over the n row blocks; `grads` = (dq, dk, dv), global
    fp32 [B, H, S, hd] views that are written in full."""
    S_l = q.shape[2] // n
    qs, ks, vs, outs, dos, dqs, dks, dvs = (t.chunk(n, dim=2)
                                            for t in (q, k, v, out, do, *grads))
    deltas = [ba.row_delta(dos[i], outs[i]) for i in range(n)]
    scratch = _new_grads(qs[0])  # the partials' buffers, allocated once a pass
    for t in range(n):
        for i in range(n):
            j = (i - t) % n  # shard j's sums "visit" shard i with its kv block
            _bwd_step(qs[i], ks[j], vs[j], dos[i], L[i], deltas[i], i * S_l, j * S_l,
                      (dqs[i], dks[j], dvs[j]), scratch, t == 0, common)


# ------------------------------- schedule: shards on the ranks of a group
def _rotate(send, recv, group):
    """Starts sending `send` to rank + 1 and receiving `recv` from rank - 1
    (`collectives.exchange`: through pinned host buffers under gloo).
    -> the requests to wait on."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return [exchange([(dist.isend, send, (r + 1) % n, 0),
                      (dist.irecv, recv, (r - 1) % n, 0)], group)]


def _packed_pair(a, b, dtype=None):
    """One contiguous [2, B, S_local, H*hd] buffer holding copies of the two
    [B, H, S_local, hd] views: what travels around the ring in one message."""
    B, H, S, hd = a.shape
    buf = torch.empty(2, B, S, H * hd, dtype=dtype or a.dtype, device=a.device)
    whk._heads4(buf[0], H).copy_(a)
    whk._heads4(buf[1], H).copy_(b)
    return buf


def _ring_fwd_ranks(q, k, v, out, group, common) -> torch.Tensor:
    """Forward ring of this rank's [B, H, S_local, hd] blocks.  Writes `out`.
    -> L fp32 [1, B, H, S_local]."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, H, S_l, hd = q.shape
    kv = _packed_pair(k, v)
    kv_next = torch.empty_like(kv)
    state, scratch = _new_state(q), _new_state(q)
    for t in range(n):
        reqs = _rotate(kv, kv_next, group) if t < n - 1 else []
        _fwd_step(q, whk._heads4(kv[0], H), whk._heads4(kv[1], H), r * S_l,
                  ((r - t) % n) * S_l, state, scratch, t == 0, common)
        for req in reqs:
            req.wait()
        kv, kv_next = kv_next, kv
    return _finish_fwd(state, out)[None]


def _ring_bwd_ranks(q, k, v, out, do, L, grads, group, common) -> None:
    """Backward ring of this rank's blocks; the dk, dv sums travel with the kv
    block, one hop after every step, and are home after the n-th."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    B, H, S_l, hd = q.shape
    dq, dk, dv = grads
    delta = ba.row_delta(do, out)
    kv = _packed_pair(k, v)
    kv_next = torch.empty_like(kv)
    dkv = torch.empty(2, B, S_l, H * hd, dtype=torch.float32, device=q.device)
    dkv_next = torch.empty_like(dkv)
    scratch = _new_grads(q)
    for t in range(n):
        reqs = _rotate(kv, kv_next, group) if t < n - 1 else []
        _bwd_step(q, whk._heads4(kv[0], H), whk._heads4(kv[1], H), do, L[0], delta, r * S_l,
                  ((r - t) % n) * S_l, (dq, whk._heads4(dkv[0], H), whk._heads4(dkv[1], H)),
                  scratch, t == 0, common)
        reqs += _rotate(dkv, dkv_next, group)
        for req in reqs:
            req.wait()
        kv, kv_next = kv_next, kv
        dkv, dkv_next = dkv_next, dkv
    dk.copy_(whk._heads4(dkv[0], H))
    dv.copy_(whk._heads4(dkv[1], H))


# ------------------------------------------------------------- autograd
class _RingAttention(torch.autograd.Function):
    """One autograd node for the head-packed layouts; `srcs` are (q, k, v)
    ("bsd") or (qkv,) ("qkv"): global tensors when `group` is None, this
    rank's blocks otherwise."""

    @staticmethod
    def forward(ctx, layout, heads, sm_scale, rate, n, group, start, end, seed, *srcs):
        q, k, v = whk._qkv_views(layout, srcs, heads)
        B, H, S, hd = q.shape
        out = q.new_empty(B, S, H * hd)
        common = (start, end, seed, sm_scale, rate)
        if group is None:
            L = _ring_fwd_local(q, k, v, whk._heads4(out, heads), n, common)
        else:
            L = _ring_fwd_ranks(q, k, v, whk._heads4(out, heads), group, common)
        if any(ctx.needs_input_grad[9:]):
            ctx.save_for_backward(start, end, seed, out, L, *srcs)
            ctx.static = (layout, heads, sm_scale, rate, n, group)
        return out

    @staticmethod
    def backward(ctx, dout):
        start, end, seed, out, L, *srcs = ctx.saved_tensors
        layout, heads, sm_scale, rate, n, group = ctx.static
        sums = [torch.empty(s.shape, dtype=torch.float32, device=s.device) for s in srcs]
        ops = (*whk._qkv_views(layout, srcs, heads), whk._heads4(out, heads),
               ba._do(whk._heads4(dout, heads)), L, whk._qkv_views(layout, sums, heads))
        common = (start, end, seed, sm_scale, rate)
        if group is None:
            _ring_bwd_local(*ops, n, common)
        else:
            _ring_bwd_ranks(*ops, group, common)
        return (None,) * 9 + tuple(g.to(s.dtype) for g, s in zip(sums, srcs))


def _check_ring(S: int, hd: int, n_shards: int, group) -> None:
    if group is not None and dist.get_world_size(group) != n_shards:
        raise ValueError(f"the process group has {dist.get_world_size(group)} ranks, "
                         f"the ring {n_shards} shards")
    if n_shards < 1 or (group is None and S % n_shards):
        raise ValueError(f"S={S} does not split into {n_shards} sequence shards")
    if not supported(S if group is not None else S // n_shards, hd):
        raise ValueError(f"no ring kernel for hd={hd}: it takes hd <= {whk.MAX_HEAD_DIM}")


def ring_attention_bsd(q, k, v, start, end, seed=None, *, n_shards, heads, group=None,
                       sm_scale=None, dropout_rate=0.0):
    """Ring attention in the head-packed layout (the JAX signature, with the
    process group in place of the axis name).  `group=None`: q, k, v and the
    result are the global [B, S, H*hd] tensors, S a multiple of `n_shards`,
    whose row blocks are the shards.  With a process group of `n_shards`
    ranks they are this rank's blocks [B, S_local, H*hd].  `start`, `end`:
    the GLOBAL key bounds per batch row (int32 [B]); `seed`: int32 [1] on
    the device, the same on every rank."""
    hd = q.shape[-1] // heads
    _check_ring(q.shape[1], hd, n_shards, group)
    if sm_scale is None:
        sm_scale = hd ** -0.5
    return _RingAttention.apply("bsd", heads, sm_scale, dropout_rate, n_shards, group,
                                start, end, seed, q, k, v)


def ring_attention_qkv(qkv, start, end, seed=None, *, n_shards, heads, group=None,
                       sm_scale=None, dropout_rate=0.0):
    """`ring_attention_bsd` of the three column slices of one [B, S, 3*H*hd]
    projection output; returns [B, S, H*hd], and its backward one
    [B, S, 3*H*hd] gradient."""
    hd = qkv.shape[-1] // (3 * heads)
    _check_ring(qkv.shape[1], hd, n_shards, group)
    if sm_scale is None:
        sm_scale = hd ** -0.5
    return _RingAttention.apply("qkv", heads, sm_scale, dropout_rate, n_shards, group,
                                start, end, seed, qkv)
