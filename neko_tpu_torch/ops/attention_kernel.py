"""Whole-head causal attention with dropout: the Hopper kernels and their
plain versions (counterpart of neko_tpu/ops/attention_kernel.py).

Contract, as in the JAX package: causal attention over keys
`start[b] <= col < end[b]` (the packer's padding is contiguous, so key
validity is one interval per batch row), an fp32 softmax, and
attention-weight dropout applied to the normalized probabilities with an
8-bit keep mask per (seed, batch, head): an element is kept when its byte is
>= q = min(round(rate * 256), 255) and survivors are scaled by
1 / (1 - q / 256).

Layouts (the JAX signatures):

* `whole_head_attention(q, k, v, start, end, seed, sm_scale, dropout_rate)`:
  q, k, v are [B, H, S, hd].
* `whole_head_attention_bsd(q, k, v, start, end, seed, heads=...)`:
  head-packed [B, S, H*hd], head h at columns [h*hd, (h+1)*hd).
* `whole_head_attention_qkv(qkv, start, end, seed, heads=...)`: q, k, v are
  the three column slices of one [B, S, 3*H*hd] projection output; the
  backward writes dq, dk and dv into one [B, S, 3*H*hd] gradient buffer.

All three are one `autograd.Function` over strided [B, H, S, hd] views (hd
contiguous): the kernels take a (batch, head, sequence) stride per tensor,
so no layout is ever copied.

Kernels (`csrc/`, CUDA C++ for sm_90a, bound with ctypes):

* `whole_head_attention_fwd` (TPU kernels #1 `_fwd_kernel` and #3
  `_fwd_kernel_bsd`): forward with dropout; writes the per-row log-sum-exp
  when autograd needs it.  Launches count in `whole_head_attention.launches`.
* `whole_head_attention_bwd` (#2 `_bwd_kernel`, #4 `_bwd_kernel_bsd`):
  recomputes p from q, k and the saved log-sum-exp.
  `whole_head_attention_bwd.launches`.
* `dropout_keep_scale` (#5): the fp32 keep/scale matrices the kernels apply.
  `dropout_keep_scale.launches`.

The keep byte of element (b, h, row, col) is byte (col % 16) of the 16-byte
Philox4x32-10 output at counter (col // 16, row, 0, 0) under key
(seed, b * H + h): it depends on (seed, b, h, row, col) alone, so neither
the layout nor the tiling changes it.  `dropout_keep_scale_reference` is the
same generator in int64 torch arithmetic (CPU or card).  The TPU's hardware
PRNG cannot be matched bit for bit; the semantics are (threshold, realized
keep rescale, independence across (b, h)).

A CPU tensor runs the plain versions (`whole_head_attention_reference`,
autograd through it for the backward, `dropout_keep_scale_reference`).  A
CUDA tensor launches the kernels or raises: there is no fallback on the card.

Head dims: the plain versions take any hd.  The kernels are compiled for
hd in `head_dims(dtype)`: in bf16 16, 32, 64 and 128 (the tensor-core
tiles, forward and backward), in fp32 32, 64 and 128 (the CUDA-core
kernels); the wrappers zero-pad any other hd <= 128 to the next of those
widths (`kernel_head_dim`) and slice the padding off the results, with
sm_scale from the true hd: zero columns change no score and no delta.  They
pad on every device, so the CPU tests run the padding route too.

Rows whose visited key set is empty (query rows before `start`, or a row
with start >= end) come out as exact zeros in every version, and get zero
gradients.  The TPU kernel writes a finite average there instead; nothing
reads those rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

_NEG = -1e30  # finite fill for masked logits, as the TPU kernel (never -inf)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128

# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3")
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def supported(S: int, hd: int, dtype) -> bool:
    """Shapes the CUDA kernels take: any S, any hd <= 128 (padded to a
    compiled width), bf16/fp32."""
    return S > 0 and 0 < hd <= MAX_HEAD_DIM and dtype in _KERNEL_DTYPES


def head_dims(dtype) -> tuple:
    """The head dims the attention kernels are compiled for, forward and
    backward: bf16 16, 32, 64, 128 (the tensor-core tiles of
    csrc/attention_fwd.cuh and attention_bwd.cuh); fp32 32, 64, 128 (their
    CUDA-core kernels)."""
    return (16, 32, 64, 128) if dtype == torch.bfloat16 else (32, 64, 128)


def kernel_head_dim(hd: int, widths) -> int:
    """The compiled width a kernel runs hd at: the least of `widths` >= hd
    (hd itself above MAX_HEAD_DIM, which the kernels refuse)."""
    return next((w for w in widths if w >= hd), hd)


def padded(width: int, *tensors):
    """The tensors with their last dim zero-padded to `width` (new
    contiguous tensors; None stays None)."""
    return tuple(None if t is None else torch.nn.functional.pad(t, (0, width - t.shape[-1]))
                 for t in tensors)


def _scale(sm_scale, hd: int) -> float:
    """sm_scale, or 1 / sqrt(hd) when it is None."""
    return hd ** -0.5 if sm_scale is None else sm_scale


def _sliced_into(res, bufs, hd):
    """The results cut to hd columns, copied into `bufs` where given."""
    return tuple(r[..., :hd] if buf is None else buf.copy_(r[..., :hd])
                 for r, buf in zip(res, bufs))


def keep_threshold(rate: float) -> int:
    """q = min(round(rate * 256), 255): the keep byte threshold (JAX
    `_keep_scale`); 0 means no dropout."""
    return min(max(int(round(rate * 256.0)), 0), 255)


def survivor_scale(q: int) -> float:
    """Survivor scale 1 / (1 - q / 256) for threshold q."""
    return 1.0 / (1.0 - q / 256.0)


def mask_bounds_from_key_mask(key_mask: torch.Tensor):
    """Contiguous validity [start, end) per row from a bool [B, S] mask
    (int32 [B] each; an all-False row gives start=S, end=0)."""
    S = key_mask.shape[-1]
    km = key_mask.to(torch.int32)
    any_valid = key_mask.any(dim=-1)
    start = torch.where(any_valid, km.argmax(dim=-1), S)
    end = torch.where(any_valid, S - km.flip(-1).argmax(dim=-1), 0)
    return start.to(torch.int32), end.to(torch.int32)


def allowed_keys(S: int, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """bool [B, 1, S, S]: col <= row and start <= col < end."""
    idx = torch.arange(S, device=start.device)
    col = idx[None, None, None, :]
    row = idx[None, None, :, None]
    st = start.long()[:, None, None, None]
    en = end.long()[:, None, None, None]
    return (col <= row) & (col >= st) & (col < en)


# ------------------------------------------------------------ keep mask
def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of a * b for a < 2^32 and int64 b in [0, 2^32),
    without leaving int64: b splits into 16-bit halves."""
    lo_part = a * (b & 0xFFFF)
    t = a * (b >> 16) + (lo_part >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def _philox4x32_10(c0, c1, c2, c3, k0, k1):
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_bytes_reference(seed: torch.Tensor, B: int, H: int, S: Optional[int],
                         rows=None, cols=None) -> torch.Tensor:
    """uint8 [B, H, S, S]: the keep byte of every element (plain Philox on
    the seed's device); with `rows` = (r0, r1) and `cols` = (c0, c1), the
    window [B, H, r1 - r0, c1 - c0] of it (S may then be None: a keep byte
    does not depend on it)."""
    dev = seed.device
    r0, r1 = (0, S) if rows is None else rows
    c0, c1 = (0, S) if cols is None else cols
    b0, b1 = c0 // 16, -(-c1 // 16)  # the 16-byte draws that cover the columns
    shape = (B * H, r1 - r0, b1 - b0)
    x0 = torch.arange(b0, b1, device=dev).view(1, 1, -1).expand(shape)
    x1 = torch.arange(r0, r1, device=dev).view(1, -1, 1).expand(shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=dev)
    k0 = seed.reshape(-1)[:1].long().view(1, 1, 1) & _U32
    k1 = torch.arange(B * H, device=dev).view(B * H, 1, 1)
    words = _philox4x32_10(x0, x1, zero, zero, k0, k1)
    shifts = torch.arange(0, 32, 8, device=dev)
    byts = torch.stack([(w[..., None] >> shifts) & 0xFF for w in words], dim=-2)
    byts = byts.reshape(B, H, r1 - r0, (b1 - b0) * 16)
    return byts[..., c0 - b0 * 16:c1 - b0 * 16].to(torch.uint8)


def dropout_keep_scale_reference(
    seed: torch.Tensor, B: int, H: int, S: Optional[int], dropout_rate: float,
    rows=None, cols=None,
) -> torch.Tensor:
    """fp32 [B, H, S, S] keep/scale matrices: scale where the keep byte is
    >= the threshold, else 0 (the plain version of kernel #5); with `rows`
    and `cols`, that window of them."""
    q = keep_threshold(dropout_rate)
    keep = keep_bytes_reference(seed, B, H, S, rows, cols) >= q
    return keep.float() * survivor_scale(q)


# ------------------------------------------------------- plain attention
def masked_attention(q, k, v, allowed, sm_scale=None, fill=_NEG, keep_scale=None):
    """Plain attention over the keys `allowed` marks (bool, broadcast to
    [B, H, Sq, Sk]): fp32 scores and softmax, then the fp32 keep/scale
    matrix when given, the probabilities cast to the value dtype before the
    value product.  A row with no allowed key averages every key (its scores
    all equal `fill`)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(scores.masked_fill(~allowed, fill), dim=-1)
    if keep_scale is not None:
        p = p * keep_scale
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def whole_head_attention_reference(q, k, v, start, end, sm_scale=None, keep_scale=None):
    """The plain torch version on [B, H, S, hd] (any strides): what the TPU
    kernel's `_attn_fwd_body` computes, with `keep_scale` (fp32
    [B, H, S, S]) in place of its in-kernel mask, and empty rows set to 0."""
    ok = allowed_keys(q.shape[-2], start, end)
    out = masked_attention(q, k, v, ok, sm_scale, keep_scale=keep_scale)
    return out.masked_fill(~ok.any(dim=-1, keepdim=True), 0)


# ------------------------------------------------------ kernel bindings
class _View(ctypes.Structure):
    """A [B, H, S, hd] view: pointer and (batch, head, sequence) strides in
    elements; hd is contiguous (csrc/attention_common.cuh `View`)."""
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("ss", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """csrc/attention_common.cuh `AttnArgs`, field for field."""
    _fields_ = [(n, _View) for n in ("q", "k", "v", "o", "dout", "dq", "dk", "dv")] + [
        ("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
        ("start", ctypes.c_void_p), ("end", ctypes.c_void_p), ("seed", ctypes.c_void_p),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("S", ctypes.c_int), ("D", ctypes.c_int),
        ("dtype", ctypes.c_int), ("drop_threshold", ctypes.c_int),
        ("sm_scale", ctypes.c_float), ("drop_scale", ctypes.c_float),
        # the blocked kernels' row stats and fp32 dq scratch (blocked_attention.py)
        ("m", ctypes.c_void_p), ("l", ctypes.c_void_p), ("dq_acc", ctypes.c_void_p),
        # the ring kernels' global row and column offsets (ring_kernel.py)
        ("q_off", ctypes.c_int), ("k_off", ctypes.c_int),
    ]


def _view(t: Optional[torch.Tensor]) -> _View:
    if t is None:
        return _View(None, 0, 0, 0)
    return _View(t.data_ptr(), *t.stride()[:3])


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_kernel_args(q, k, v, start, end, seed=None) -> None:
    """What the CUDA kernels take (hd one of the compiled `head_dims`); raises
    ValueError on anything else."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, hd], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    B, _, S, hd = q.shape
    if not (supported(S, hd, q.dtype) and hd in head_dims(q.dtype)):
        raise ValueError(
            f"no kernel for S={S}, hd={hd}, {q.dtype}: it takes hd in {head_dims(q.dtype)} "
            f"(the wrappers pad any hd <= {MAX_HEAD_DIM}) and dtypes {list(_KERNEL_DTYPES)}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous (stride 1)")
    for name, t in (("start", start), ("end", end)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous int32 [{B}], got {t.dtype} {tuple(t.shape)}"
            )
    tensors = [("q", q), ("k", k), ("v", v), ("start", start), ("end", end)]
    if seed is not None:
        if seed.dtype != torch.int32 or seed.numel() < 1:
            raise ValueError(f"seed must be int32 [1], got {seed.dtype} {tuple(seed.shape)}")
        tensors.append(("seed", seed))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_like(q, **tensors) -> None:
    for name, t in tensors.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)} {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous (stride 1)")


def _check_aligned16(**tensors) -> None:
    """The bf16 tensor-core tiles copy 16 bytes at a time: each [B, H, S, hd]
    view they read needs a 16-byte aligned pointer and (batch, head, row)
    strides that are multiples of 16 bytes."""
    for name, t in tensors.items():
        if t is None or t.dtype != torch.bfloat16:
            continue
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name}: the bf16 tiles need 16-byte aligned rows, got "
                             f"strides {t.stride()}")


def _entry(library: str, symbol: str, args_type=_Args):
    from neko_tpu_torch.ops.cuda_build import load_library

    fn = getattr(load_library(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _call(library: str, symbol: str, args: ctypes.Structure, device) -> None:
    """Launch `symbol(&args, stream)` of a kernel library on `device`'s
    current stream; `args` is its argument struct (`_Args` or another)."""
    fn = _entry(library, symbol, type(args))
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        shape = ", ".join(f"{n}={getattr(args, n)}" for n, _ in args._fields_
                          if n in ("B", "H", "S", "D", "dtype"))
        raise RuntimeError(f"{symbol} kernel launch failed: cudaError_t {err} ({shape})")


def _kernel_args(q, k, v, start, end, seed, sm_scale, q_thr, q_off=0, k_off=0,
                 **views) -> _Args:
    B, H, S, hd = q.shape
    return _Args(
        q_off=q_off, k_off=k_off,
        q=_view(q), k=_view(k), v=_view(v),
        **{n: _view(views.get(n)) for n in ("o", "dout", "dq", "dk", "dv")},
        lse=_ptr(views.get("lse")), delta=_ptr(views.get("delta")),
        m=_ptr(views.get("m")), l=_ptr(views.get("l")), dq_acc=_ptr(views.get("dq_acc")),
        start=start.data_ptr(), end=end.data_ptr(), seed=_ptr(seed),
        B=B, H=H, S=S, D=hd, dtype=_KERNEL_DTYPES[q.dtype],
        drop_threshold=q_thr, sm_scale=float(sm_scale), drop_scale=survivor_scale(q_thr),
    )


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no whole_head_attention for device {q.device}")
    return q.device.type


def _threshold(seed, dropout_rate) -> int:
    """The keep threshold for `dropout_rate` (0: no dropout); dropout needs
    a seed."""
    q_thr = keep_threshold(dropout_rate) if dropout_rate > 0.0 else 0
    if q_thr and seed is None:
        raise ValueError("dropout requires an explicit seed (int32 [1] tensor)")
    return q_thr


def _plain_keep_scale(q, seed, q_thr, dropout_rate):
    B, H, S, _ = q.shape
    return dropout_keep_scale_reference(seed, B, H, S, dropout_rate) if q_thr else None


# ----------------------------------------------------- forward / backward
def whole_head_attention_fwd(
    q, k, v, start, end, seed=None, sm_scale=None, dropout_rate=0.0,
    out=None, need_lse=False,
):
    """Forward on [B, H, S, hd] views (hd contiguous, any other strides).
    Writes into `out` when given.  -> (out, fp32 [B, H, S] log-sum-exp when
    `need_lse` on the card, else None)."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    width = kernel_head_dim(hd, head_dims(q.dtype))
    if width != hd:
        res, lse = whole_head_attention_fwd(*padded(width, q, k, v), start, end, seed, sm_scale,
                                            dropout_rate, need_lse=need_lse)
        return _sliced_into((res,), (out,), hd)[0], lse
    q_thr = _threshold(seed, dropout_rate)
    if _device_of(q) == "cpu":
        ks = _plain_keep_scale(q, seed, q_thr, dropout_rate)
        res = whole_head_attention_reference(q, k, v, start, end, sm_scale, ks)
        return (res if out is None else out.copy_(res)), None
    _check_kernel_args(q, k, v, start, end, seed if q_thr else None)
    _check_aligned16(q=q, k=k, v=v)
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check_like(q, out=out)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device) if need_lse else None
    args = _kernel_args(q, k, v, start, end, seed if q_thr else None, sm_scale, q_thr,
                        o=out, lse=lse)
    _call("whole_head_attention", "whole_head_attention_fwd", args, q.device)
    whole_head_attention.launches += 1
    return out, lse


def whole_head_attention_bwd(
    q, k, v, out, dout, lse, start, end, seed=None, sm_scale=None,
    dropout_rate=0.0, dq=None, dk=None, dv=None,
):
    """Backward on [B, H, S, hd] views: (dq, dk, dv), written into the given
    buffers when passed.  On the card it needs the forward's `out` and
    `lse`; the plain version (CPU) is autograd through
    `whole_head_attention_reference` and reads neither."""
    B, H, S, hd = q.shape
    if sm_scale is None:
        sm_scale = hd ** -0.5
    width = kernel_head_dim(hd, head_dims(q.dtype))
    if width != hd:
        res = whole_head_attention_bwd(*padded(width, q, k, v, out, dout), lse, start, end, seed,
                                       sm_scale, dropout_rate)
        return _sliced_into(res, (dq, dk, dv), hd)
    q_thr = _threshold(seed, dropout_rate)
    if _device_of(q) == "cpu":
        ks = _plain_keep_scale(q, seed, q_thr, dropout_rate)
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            res = whole_head_attention_reference(*qkv, start, end, sm_scale, ks)
            grads = torch.autograd.grad(res, qkv, dout)
        return tuple(g if buf is None else buf.copy_(g)
                     for g, buf in zip(grads, (dq, dk, dv)))
    _check_kernel_args(q, k, v, start, end, seed if q_thr else None)
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  if buf is None else buf for t, buf in zip((q, k, v), (dq, dk, dv)))
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _check_like(q, out=out, dout=dout, dq=dq, dk=dk, dv=dv)
    _check_aligned16(q=q, k=k, v=v, dout=dout)
    if lse is None or lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be the forward's contiguous fp32 [B, H, S] log-sum-exp")
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    args = _kernel_args(q, k, v, start, end, seed if q_thr else None, sm_scale, q_thr,
                        o=out, dout=dout, dq=dq, dk=dk, dv=dv, lse=lse, delta=delta)
    _call("whole_head_attention_bwd", "whole_head_attention_bwd", args, q.device)
    whole_head_attention_bwd.launches += 1
    return dq, dk, dv


whole_head_attention_bwd.launches = 0


class _MaskArgs(ctypes.Structure):
    """csrc/dropout_keep_scale.cu `MaskArgs`, field for field."""
    _fields_ = [("out", ctypes.c_void_p), ("seed", ctypes.c_void_p),
                ("B", ctypes.c_int), ("H", ctypes.c_int), ("S", ctypes.c_int),
                ("drop_threshold", ctypes.c_int), ("drop_scale", ctypes.c_float)]


def dropout_keep_scale(seed: torch.Tensor, B: int, H: int, S: int, dropout_rate: float):
    """fp32 [B, H, S, S] keep/scale matrices the kernels apply, on the
    seed's device: kernel #5 on the card, the plain Philox on the CPU."""
    if seed.device.type == "cpu":
        return dropout_keep_scale_reference(seed, B, H, S, dropout_rate)
    if seed.device.type != "cuda" or seed.dtype != torch.int32 or seed.numel() < 1:
        raise ValueError(f"seed must be an int32 [1] tensor on the card, got {seed}")
    out = torch.empty(B, H, S, S, dtype=torch.float32, device=seed.device)
    q_thr = keep_threshold(dropout_rate)
    args = _MaskArgs(out=out.data_ptr(), seed=seed.data_ptr(), B=B, H=H, S=S,
                     drop_threshold=q_thr, drop_scale=survivor_scale(q_thr))
    _call("dropout_keep_scale", "dropout_keep_scale", args, seed.device)
    dropout_keep_scale.launches += 1
    return out


dropout_keep_scale.launches = 0


# ------------------------------------------------------------- autograd
def _heads4(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*hd] (any row stride) -> [B, H, S, hd] view."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2)


def _qkv_views(layout: str, srcs, heads: int):
    if layout == "bhsd":
        return srcs
    if layout == "qkv":
        srcs = srcs[0].chunk(3, dim=-1)
    return tuple(_heads4(t, heads) for t in srcs)


def _out_view(layout: str, out: torch.Tensor, heads: int) -> torch.Tensor:
    return out if layout == "bhsd" else _heads4(out, heads)


class _Attention(torch.autograd.Function):
    """One autograd node for every layout; `srcs` are (q, k, v) or (qkv,)."""

    @staticmethod
    def forward(ctx, layout, heads, sm_scale, rate, start, end, seed, *srcs):
        q, k, v = _qkv_views(layout, srcs, heads)
        B, H, S, hd = q.shape
        shape = (B, H, S, hd) if layout == "bhsd" else (B, S, H * hd)
        out = q.new_empty(shape)
        need_grad = any(ctx.needs_input_grad[7:])
        _, lse = whole_head_attention_fwd(
            q, k, v, start, end, seed, sm_scale, rate,
            out=_out_view(layout, out, heads), need_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(start, end, seed, out, lse, *srcs)
            ctx.static = (layout, heads, sm_scale, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        start, end, seed, out, lse, *srcs = ctx.saved_tensors
        layout, heads, sm_scale, rate = ctx.static
        grads = [torch.empty(s.shape, dtype=s.dtype, device=s.device) for s in srcs]
        dq, dk, dv = _qkv_views(layout, grads, heads)
        whole_head_attention_bwd(
            *_qkv_views(layout, srcs, heads), _out_view(layout, out, heads),
            _out_view(layout, dout, heads), lse, start, end, seed, sm_scale, rate,
            dq=dq, dk=dk, dv=dv)
        return (None,) * 7 + tuple(grads)


def whole_head_attention(
    q, k, v, start, end, seed=None, sm_scale=None, dropout_rate=0.0
):
    """Causal attention with contiguous key validity [start, end) per batch.

    q, k, v: [B, H, S, hd]; start/end: int32 [B]; seed: int32 [1] tensor
    on q's device (needed when dropout_rate > 0).  Returns [B, H, S, hd].
    CPU tensors run the plain version; CUDA tensors the kernels (or raise).
    `whole_head_attention.launches` counts forward kernel launches."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Attention.apply("bhsd", q.shape[1], sm_scale, dropout_rate,
                            start, end, seed, q, k, v)


whole_head_attention.launches = 0


def whole_head_attention_bsd(
    q, k, v, start, end, seed=None, *, heads, sm_scale=None, dropout_rate=0.0
):
    """Head-packed whole-head attention: q, k, v and the result are
    [B, S, H*hd] (any row stride), with the masking and dropout of
    `whole_head_attention` (the same keep mask per (batch, head))."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // heads) ** -0.5
    return _Attention.apply("bsd", heads, sm_scale, dropout_rate,
                            start, end, seed, q, k, v)


def whole_head_attention_qkv(
    qkv, start, end, seed=None, *, heads, sm_scale=None, dropout_rate=0.0
):
    """`whole_head_attention_bsd` of the three column slices of one
    [B, S, 3*H*hd] projection output; returns [B, S, H*hd], and its backward
    returns one [B, S, 3*H*hd] gradient (no concatenation copy)."""
    if sm_scale is None:
        sm_scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    return _Attention.apply("qkv", heads, sm_scale, dropout_rate,
                            start, end, seed, qkv)
