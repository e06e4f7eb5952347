"""Decode-step cache attention: the Hopper kernel and its plain version
(counterpart of neko_tpu/ops/decode_attention.py).

Per generated token each (batch row, head) attends ONE query to the KV cache
over the rows `start[b] <= j < end[b]` whose `key_mask[b, j]` is set: fp32
scores, an fp32 softmax, the fp32 value sum, one output row in the query's
dtype.  The JAX signature takes the newest row inclusive (`index`); here the
bounds are [start, end) with end = index + 1, int32 [B] on the device, as
every kernel of the port takes them.  The window is the range of work; the
mask (bool [B, S], the cache's valid rows, as neko_tpu's decode step masks
its bias with it) drops the rows inside it that are not valid, so a mask
with holes is attended as neko_tpu attends it.  Without a mask every row of
the window is valid.  The caches are read, never written (the decode step
writes the new row in place before the call).

* `decode_cache_attention(q, k_cache, v_cache, start, end, key_mask=None)`:
  q [B, H, hd], caches [B, H, S, hd], -> [B, H, hd].  A CUDA tensor launches
  kernel #14 (`csrc/decode_attention.cu`) and counts it in
  `decode_cache_attention.launches`; a CPU tensor runs the plain version.
  No fallback on the card.
* `decode_cache_attention_reference`: the plain version, the port's former
  decode body (`attention_kernel.masked_attention` over the valid rows of the
  window: the probabilities rounded to the value dtype before the value
  product, as the TPU kernel rounds them).  A row with no valid key is 0 in
  both versions, never NaN.
* `supported(B, H, S, hd)`: any hd <= 128, any S; the kernel is compiled for
  hd in {16, 32, 64, 128} and the wrapper zero-pads any other hd to the next
  of them (sm_scale from the true hd), on every device.  The 128-multiple S
  and the VMEM cap of the TPU kernel do not bind a CUDA kernel.

On the TPU the kernel lost to XLA's two einsums on the v5e's DMA stream rate
and was never wired in; the port's decode step runs it on every layer of
every generated token.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neko_tpu_torch.ops import attention_kernel as whk

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def supported(B: int, H: int, S: int, hd: int) -> bool:
    """Shapes the CUDA kernel takes: any hd <= 128, any B, H, S > 0."""
    return B > 0 and H > 0 and S > 0 and 0 < hd <= whk.MAX_HEAD_DIM


def key_window(S: int, start: torch.Tensor, end: torch.Tensor, key_mask=None) -> torch.Tensor:
    """bool [B, 1, 1, S]: start[b] <= j < end[b] (and key_mask[b, j])."""
    j = torch.arange(S, device=start.device)[None, :]
    ok = (j >= start.long()[:, None]) & (j < end.long()[:, None])
    if key_mask is not None:
        ok = ok & key_mask
    return ok[:, None, None, :]


def decode_cache_attention_reference(q, k_cache, v_cache, start, end, sm_scale=None,
                                     key_mask=None):
    """The plain version: q [B, H, hd] over caches [B, H, S, hd] at the keys
    [start, end) that `key_mask` keeps -> [B, H, hd] in q's dtype; rows with
    no key are 0."""
    ok = key_window(k_cache.shape[2], start, end, key_mask)
    out = whk.masked_attention(q[:, :, None], k_cache, v_cache, ok, sm_scale)[:, :, 0]
    return out.masked_fill(~ok.any(dim=-1)[:, :, 0, None], 0).to(q.dtype)


class _View(ctypes.Structure):
    """csrc/decode_attention.cu `View`: pointer and (batch, head, row) strides
    in elements; hd is contiguous."""
    _fields_ = [("ptr", ctypes.c_void_p), ("sb", ctypes.c_longlong),
                ("sh", ctypes.c_longlong), ("ss", ctypes.c_longlong)]


class _Args(ctypes.Structure):
    """csrc/decode_attention.cu `DecodeArgs`, field for field."""
    _fields_ = [("q", _View), ("k", _View), ("v", _View), ("o", _View),
                ("start", ctypes.c_void_p), ("end", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("mask_sb", ctypes.c_longlong),
                ("B", ctypes.c_int), ("H", ctypes.c_int), ("S", ctypes.c_int),
                ("D", ctypes.c_int), ("dtype", ctypes.c_int), ("sm_scale", ctypes.c_float)]


def _view(t: torch.Tensor) -> _View:
    if t.dim() == 3:  # [B, H, hd]: no row stride
        return _View(t.data_ptr(), t.stride(0), t.stride(1), 0)
    return _View(t.data_ptr(), *t.stride()[:3])


def _check(q, k_cache, v_cache, start, end, key_mask) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, H, hd] and the caches [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, S, hd = k_cache.shape
    if v_cache.shape != k_cache.shape or q.shape != (B, H, hd):
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}: the kernel "
                         f"takes one of {list(_KERNEL_DTYPES)}")
    if not (supported(B, H, S, hd) and hd in KERNEL_HEAD_DIMS):
        raise ValueError(f"no kernel for B={B}, H={H}, S={S}, hd={hd}: hd in "
                         f"{KERNEL_HEAD_DIMS} (the wrapper pads any hd <= {whk.MAX_HEAD_DIM})")
    vec = 16 // q.element_size()  # the kernel loads 16 bytes at a time
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name}: hd must be contiguous and rows 16-byte aligned")
    for name, t in (("start", start), ("end", end)):
        if t.dtype != torch.int32 or t.shape != (B,) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 [{B}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if key_mask is not None and (key_mask.dtype != torch.bool or key_mask.shape != (B, S)
                                 or key_mask.stride(-1) != 1):
        raise ValueError(f"key_mask must be bool [{B}, {S}] with contiguous rows, got "
                         f"{key_mask.dtype} {tuple(key_mask.shape)}")
    named = [("k_cache", k_cache), ("v_cache", v_cache), ("start", start), ("end", end)]
    if key_mask is not None:
        named.append(("key_mask", key_mask))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def decode_cache_attention(q, k_cache, v_cache, start, end, key_mask=None,
                           sm_scale: Optional[float] = None):
    """One query per (b, h) over the cache rows [start[b], end[b]) that
    `key_mask` keeps.  q [B, H, hd]; k_cache, v_cache [B, H, S, hd] (hd
    contiguous); start, end int32 [B] and key_mask bool [B, S] (or None:
    the whole window) on q's device.  -> [B, H, hd] in q's dtype."""
    hd = q.shape[-1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    width = whk.kernel_head_dim(hd, KERNEL_HEAD_DIMS)
    if width != hd:  # a copy of the caches a call: odd head dims only
        out = decode_cache_attention(*whk.padded(width, q, k_cache, v_cache), start, end,
                                     key_mask, sm_scale)
        return out[..., :hd]
    if q.device.type == "cpu":
        return decode_cache_attention_reference(q, k_cache, v_cache, start, end, sm_scale,
                                                key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_cache_attention for device {q.device}")
    _check(q, k_cache, v_cache, start, end, key_mask)
    B, H, S, hd = k_cache.shape
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    args = _Args(q=_view(q), k=_view(k_cache), v=_view(v_cache), o=_view(out),
                 start=start.data_ptr(), end=end.data_ptr(),
                 mask=None if key_mask is None else key_mask.data_ptr(),
                 mask_sb=0 if key_mask is None else key_mask.stride(0), B=B, H=H, S=S, D=hd,
                 dtype=_KERNEL_DTYPES[q.dtype], sm_scale=float(sm_scale))
    from neko_tpu_torch.ops.cuda_build import load_library

    fn = load_library("decode_attention").decode_cache_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_cache_attention kernel launch failed: cudaError_t {err} "
                           f"(B={B}, H={H}, S={S}, hd={hd}, {q.dtype})")
    decode_cache_attention.launches += 1
    return out


decode_cache_attention.launches = 0
