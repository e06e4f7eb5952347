"""Whole-head causal attention: the Hopper kernel and its plain version
(counterpart of neko_tpu/ops/attention_kernel.py, forward without dropout).

`whole_head_attention(q, k, v, start, end)` keeps the JAX signature and
layout: q, k, v are [B, H, S, hd], start/end int32 [B], and the result is
causal attention over keys `start[b] <= col < end[b]` (the packer's padding
is contiguous, so key validity is one interval per batch row), with an fp32
softmax.

* A CPU tensor goes to `whole_head_attention_reference`, the plain torch
  version.
* A CUDA tensor launches the CUDA kernel `csrc/whole_head_attention.cu`, or
  raises.  There is no fallback on the card.

Rows whose visited key set is empty (query rows before `start`, or a row
with start >= end) come out as exact zeros in both versions.  The TPU kernel
writes a finite average there instead; nothing reads those rows.
"""

from __future__ import annotations

import ctypes

import torch

_NEG = -1e30  # finite fill for masked logits, as the TPU kernel (never -inf)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


def supported(S: int, hd: int, dtype) -> bool:
    """Shapes the CUDA kernel takes: any S, hd in {32, 64, 128}, bf16/fp32."""
    return S > 0 and hd in _KERNEL_HEAD_DIMS and dtype in _KERNEL_DTYPES


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


def masked_attention(q, k, v, allowed, sm_scale=None, fill=_NEG):
    """Plain attention over the keys `allowed` marks (bool, broadcast to
    [B, H, Sq, Sk]): fp32 scores and softmax, the probabilities cast to the
    value dtype before the value product.  A row with no allowed key averages
    every key (its scores all equal `fill`)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(scores.masked_fill(~allowed, fill), dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


def whole_head_attention_reference(q, k, v, start, end, sm_scale=None):
    """The plain torch version: what the TPU kernel's `_attn_fwd_body`
    computes at dropout_rate = 0, with empty rows set to 0."""
    ok = allowed_keys(q.shape[-2], start, end)
    out = masked_attention(q, k, v, ok, sm_scale)
    return out.masked_fill(~ok.any(dim=-1, keepdim=True), 0)


def _check_kernel_args(q, k, v, start, end) -> None:
    """What the CUDA kernel takes; raises ValueError on anything else."""
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
    if not supported(S, hd, q.dtype):
        raise ValueError(
            f"no kernel for S={S}, hd={hd}, {q.dtype}: it takes hd in "
            f"{_KERNEL_HEAD_DIMS} and dtypes {list(_KERNEL_DTYPES)}"
        )
    for name, t in (("start", start), ("end", end)):
        if t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(
                f"{name} must be int32 [{B}], got {t.dtype} {tuple(t.shape)}"
            )
    for name, t in (("q", q), ("k", k), ("v", v), ("start", start), ("end", end)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _lib():
    from neko_tpu_torch.ops.cuda_build import load_library

    lib = load_library("whole_head_attention")
    fn = lib.whole_head_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, start, end, sm_scale):
    _check_kernel_args(q, k, v, start, end)
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            start.data_ptr(), end.data_ptr(), out.data_ptr(),
            B, H, S, hd, _KERNEL_DTYPES[q.dtype], float(sm_scale), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"whole_head_attention kernel launch failed: cudaError_t {err} "
            f"(B={B}, H={H}, S={S}, hd={hd}, dtype={q.dtype})"
        )
    whole_head_attention.launches += 1
    return out


def whole_head_attention(
    q, k, v, start, end, seed=None, sm_scale=None, dropout_rate=0.0
):
    """Causal attention with contiguous key validity [start, end) per batch.

    q, k, v: [B, H, S, hd]; start/end: int32 [B].  Returns [B, H, S, hd].
    CPU tensors run the plain version; CUDA tensors the kernel (or raise).
    `seed` is accepted for signature parity and unused without dropout;
    dropout_rate > 0 (attention-weight dropout, training only) is not
    ported yet.  `whole_head_attention.launches` counts kernel launches."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout in whole_head_attention is not yet ported "
            "(it comes with the training kernels)"
        )
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return whole_head_attention_reference(q, k, v, start, end, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no whole_head_attention for device {q.device}")
    return _launch(q, k, v, start, end, sm_scale)


whole_head_attention.launches = 0
