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
* `decode_cache_attention_int8(q, k_q, k_scale, v_q, v_scale, start, end,
  key_mask=None)`: the same over an int8 cache (`ModelConfig.kv_cache_dtype
  = 'int8'`): rows int8 [B, H, S, hd], one fp32 scale a row [B, H, S]
  (`quant_rows`).  It computes neko_tpu's `_quant_cache_attention` (an XLA
  path there): scores q . k_int8 * hd^-0.5 * k_scale[j], an fp32 softmax,
  the sum of p_j * v_scale[j] * v_int8[j].  A CUDA tensor launches #14's int8
  instance (counted in `decode_cache_attention_int8.launches`), which keeps
  p * v_scale in fp32 where neko_tpu rounds it to the activation dtype; a CPU
  tensor runs `decode_cache_attention_int8_reference`, the plain
  `quant_cache_attention` over the window and mask.  The hd padding pads the
  int8 rows with zeros and leaves the scales as they are.
* `quant_rows(x)`: neko_tpu's `_quant_rows`, symmetric per-row int8
  (scale = max|row| / 127; an all-zero row has scale 0 and quantizes to 0).
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


def quant_rows(x: torch.Tensor):
    """Symmetric per-row int8 quantization [..., hd] -> (int8, fp32 scale
    [...]), as neko_tpu computes it (its 1e-30 floor guards the divide only;
    torch.round and jnp.round both round half to even; the divisor is a
    tensor on x's device, since torch divides a CUDA tensor by a Python
    number as a product with its reciprocal)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / xf.new_tensor(127.0)
    q = torch.round(xf / torch.clamp(scale[..., None], min=1e-30))
    return q.to(torch.int8), scale


def quant_cache_attention(q, k_q, k_scale, v_q, v_scale, allowed, sm_scale=None,
                          fill: float = -1e9):
    """neko_tpu's `_quant_cache_attention` with the allowed keys (bool,
    broadcast to [B, H, Sq, Sk]) in place of its additive bias: q [B, H, Sq,
    hd] over int8 rows [B, H, Sk, hd] with fp32 row scales [B, H, Sk]; fp32
    scores scaled by the key scales, an fp32 softmax, the probabilities times
    the value scales rounded to q's dtype before the value product.
    -> [B, H, Sq, hd] in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k_q.float().transpose(-1, -2)) * sm_scale
    scores = scores * k_scale[:, :, None, :]
    p = torch.softmax(scores.masked_fill(~allowed, fill), dim=-1)
    p = (p * v_scale[:, :, None, :]).to(q.dtype)
    return torch.matmul(p.float(), v_q.float()).to(q.dtype)


def decode_cache_attention_int8_reference(q, k_q, k_scale, v_q, v_scale, start, end,
                                          sm_scale=None, key_mask=None):
    """The int8 path's plain version: q [B, H, hd] over the int8 rows
    [start, end) that `key_mask` keeps -> [B, H, hd] in q's dtype; rows with
    no key are 0."""
    ok = key_window(k_q.shape[2], start, end, key_mask)
    out = quant_cache_attention(q[:, :, None], k_q, k_scale, v_q, v_scale, ok,
                                sm_scale)[:, :, 0]
    return out.masked_fill(~ok.any(dim=-1)[:, :, 0, None], 0).to(q.dtype)


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
                ("D", ctypes.c_int), ("dtype", ctypes.c_int), ("sm_scale", ctypes.c_float),
                ("int8_cache", ctypes.c_int), ("ks", _View), ("vs", _View)]


def _view(t: torch.Tensor) -> _View:
    if t.dim() == 3:  # [B, H, hd]: no row stride
        return _View(t.data_ptr(), t.stride(0), t.stride(1), 0)
    return _View(t.data_ptr(), *t.stride()[:3])


def _check(q, k_cache, v_cache, start, end, key_mask, scales=None) -> None:
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be [B, H, hd] and the caches [B, H, S, hd], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, S, hd = k_cache.shape
    if v_cache.shape != k_cache.shape or q.shape != (B, H, hd):
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, k {tuple(k_cache.shape)}, "
                         f"v {tuple(v_cache.shape)}")
    cache_dtype = q.dtype if scales is None else torch.int8
    if (not (k_cache.dtype == v_cache.dtype == cache_dtype)
            or q.dtype not in _KERNEL_DTYPES):
        raise ValueError(f"dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}: the kernel "
                         f"takes q in one of {list(_KERNEL_DTYPES)} and caches of q's dtype "
                         "(int8 with row scales)")
    if not (supported(B, H, S, hd) and hd in KERNEL_HEAD_DIMS):
        raise ValueError(f"no kernel for B={B}, H={H}, S={S}, hd={hd}: hd in "
                         f"{KERNEL_HEAD_DIMS} (the wrapper pads any hd <= {whk.MAX_HEAD_DIM})")
    # the kernel loads 16 bytes of a cache row at a time, and as many
    # columns of q
    vec = 16 // k_cache.element_size()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError(f"{name}: hd must be contiguous and rows 16-byte aligned")
    for name, t in zip(("k_scale", "v_scale"), scales or ()):
        if t.dtype != torch.float32 or t.shape != (B, H, S) or t.stride(-1) != 1:
            raise ValueError(f"{name} must be fp32 [{B}, {H}, {S}] with contiguous rows, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
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
    out = _launch(q, k_cache, v_cache, start, end, key_mask, sm_scale)
    decode_cache_attention.launches += 1
    return out


def decode_cache_attention_int8(q, k_q, k_scale, v_q, v_scale, start, end, key_mask=None,
                                sm_scale: Optional[float] = None):
    """`decode_cache_attention` over an int8 cache: k_q, v_q int8 [B, H, S,
    hd] (hd contiguous), k_scale, v_scale fp32 [B, H, S] row scales.
    -> [B, H, hd] in q's dtype."""
    hd = q.shape[-1]
    if sm_scale is None:
        sm_scale = hd ** -0.5
    width = whk.kernel_head_dim(hd, KERNEL_HEAD_DIMS)
    if width != hd:  # zero columns: the scales stay as they are
        q_p, k_p, v_p = whk.padded(width, q, k_q, v_q)
        out = decode_cache_attention_int8(q_p, k_p, k_scale, v_p, v_scale, start, end,
                                          key_mask, sm_scale)
        return out[..., :hd]
    if q.device.type == "cpu":
        return decode_cache_attention_int8_reference(q, k_q, k_scale, v_q, v_scale, start,
                                                     end, sm_scale, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"no decode_cache_attention_int8 for device {q.device}")
    _check(q, k_q, v_q, start, end, key_mask, scales=(k_scale, v_scale))
    out = _launch(q, k_q, v_q, start, end, key_mask, sm_scale, (k_scale, v_scale))
    decode_cache_attention_int8.launches += 1
    return out


def _launch(q, k_cache, v_cache, start, end, key_mask, sm_scale, scales=None):
    """Kernel #14 on checked CUDA tensors (int8 rows with `scales`)."""
    B, H, S, hd = k_cache.shape
    out = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
    none = _View(None, 0, 0, 0)
    ks, vs = (none, none) if scales is None else (_view(t) for t in scales)
    args = _Args(q=_view(q), k=_view(k_cache), v=_view(v_cache), o=_view(out),
                 start=start.data_ptr(), end=end.data_ptr(),
                 mask=None if key_mask is None else key_mask.data_ptr(),
                 mask_sb=0 if key_mask is None else key_mask.stride(0), B=B, H=H, S=S, D=hd,
                 dtype=_KERNEL_DTYPES[q.dtype], sm_scale=float(sm_scale),
                 int8_cache=int(scales is not None), ks=ks, vs=vs)
    from neko_tpu_torch.ops.cuda_build import load_library

    fn = load_library("decode_attention").decode_cache_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        cache = "int8" if scales is not None else str(q.dtype)
        raise RuntimeError(f"decode_cache_attention kernel launch failed: cudaError_t {err} "
                           f"(B={B}, H={H}, S={S}, hd={hd}, {q.dtype}, {cache} cache)")
    return out


decode_cache_attention.launches = 0
decode_cache_attention_int8.launches = 0
