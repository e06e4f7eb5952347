"""Fused loss-head forward: the Hopper kernel and its plain version
(counterpart of neko_tpu/ops/loss_kernel.py).

Per row of x [N, D], with the head weight W [V, D] (the torch layout: the
JAX kernel takes its transpose [D, V]): logz = logsumexp of the logits
x @ W^T over the columns < valid_vocab (the padded columns get a finite
-1e30 fill), and the logit of the row's target column, both fp32, without
materializing the [N, V] logits.

* `fused_logz_tl(x, t, W, valid_vocab)`: a CUDA tensor launches kernel #15
  (`csrc/fused_logz_tl.cu`: the tile product on the tensor cores, an online
  logsumexp over vocabulary tiles, the vocabulary split over blocks and a
  merge pass) and counts it in `fused_logz_tl.launches`; a CPU tensor runs
  the plain version.  No fallback on the card.
* `fused_logz_tl_reference`: the plain version, the forward of the port's
  loss (`losses._chunk_logits` + logsumexp + gather) with the logits in fp32.
* `fused_supported(N, D, V, dtype)`: the shapes the kernel takes.
* `_pick_vb`: the TPU kernel's vocabulary block (the largest 128-multiple
  <= 1536 that divides V).  The CUDA kernel walks 128-column tiles and masks
  a ragged V itself, so it needs none; kept for the parity of the record.

A check kernel, as in the JAX package, whose loss path never dispatches it:
the port's loss (`ops/losses.py`) keeps its cuBLAS head matmul and torch
logsumexp; `chip_smoke.py` holds the kernel against its plain version and
times it against that route.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from neko_tpu_torch.ops.losses import _chunk_logits

_ROWS_PER_BLOCK = 128  # csrc/fused_logz_tl.cu BM
_K_STEP = 32           # csrc/fused_logz_tl.cu BK: D must be a multiple


def _pick_vb(V: int) -> int:
    """Largest 128-multiple vocab block <= ~1536 that divides V (0 if none)."""
    best = 0
    for mult in range(1, V // 128 + 1):
        vb = 128 * mult
        if vb > 1536:
            break
        if V % vb == 0:
            best = vb
    return best


def fused_supported(N: int, D: int, V: int, dtype=torch.bfloat16) -> bool:
    """True when the CUDA kernel takes this shape: bf16 operands (the tensor
    cores' input type here), D a multiple of 32, any N and V."""
    return dtype == torch.bfloat16 and N > 0 and V > 0 and D > 0 and D % _K_STEP == 0


def fused_logz_tl_reference(x, t, W, valid_vocab: Optional[int] = None):
    """The plain version: the [N, V] logits in fp32 (padded columns -1e30),
    their logsumexp and the target column.  -> (logz, tl), fp32 [N] each.
    The product runs in fp32 on the operands as given (a product of two bf16
    values is exact in fp32), as both kernels accumulate it; the port's loss
    runs it in the operands' dtype."""
    logits = _chunk_logits(x.float(), W.float(), valid_vocab)
    return torch.logsumexp(logits, dim=-1), logits.gather(1, t.long()[:, None])[:, 0]


class _Args(ctypes.Structure):
    """csrc/fused_logz_tl.cu `LossArgs`, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("t", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("logz", ctypes.c_void_p), ("tl", ctypes.c_void_p),
                ("sx", ctypes.c_longlong), ("sw", ctypes.c_longlong),
                ("N", ctypes.c_int), ("D", ctypes.c_int), ("V", ctypes.c_int),
                ("valid_vocab", ctypes.c_int), ("n_split", ctypes.c_int)]


def _check(x, t, W) -> None:
    if x.dim() != 2 or W.dim() != 2 or x.shape[1] != W.shape[1]:
        raise ValueError(f"x must be [N, D] and W [V, D], got {tuple(x.shape)}, "
                         f"{tuple(W.shape)}")
    N, D = x.shape
    if x.dtype != W.dtype or not fused_supported(N, D, W.shape[0], x.dtype):
        raise ValueError(f"no kernel for N={N}, D={D}, V={W.shape[0]}, {x.dtype}/{W.dtype}: "
                         f"it takes bf16 x and W and D a multiple of {_K_STEP}")
    for name, a in (("x", x), ("W", W)):
        if a.stride(1) != 1 or a.stride(0) % 8 or a.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned")
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    if t.shape != (N,) or t.device != x.device:
        raise ValueError(f"t must be [{N}] on {x.device}, got {tuple(t.shape)} {t.device}")


def fused_logz_tl(x, t, W, valid_vocab: Optional[int] = None):
    """(logz, target logit) per row, fp32 [N] each, without the [N, V]
    logits.  x [N, D], t [N] target ids (clipped to the valid vocabulary),
    W [V, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_logz_tl_reference(x, t, W, valid_vocab)
    if x.device.type != "cuda":
        raise ValueError(f"no fused_logz_tl for device {x.device}")
    _check(x, t, W)
    N, D = x.shape
    V = W.shape[0]
    valid = V if valid_vocab is None else min(V, valid_vocab)
    # split the vocabulary over blocks until there are about two per SM
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    row_blocks = -(-N // _ROWS_PER_BLOCK)
    n_split = max(1, min(-(-V // 128), -(-2 * sms // row_blocks)))
    part = torch.empty(3, n_split, N, dtype=torch.float32, device=x.device)
    logz = torch.empty(N, dtype=torch.float32, device=x.device)
    tl = torch.empty(N, dtype=torch.float32, device=x.device)
    t32 = t.to(torch.int32).contiguous()
    args = _Args(x=x.data_ptr(), w=W.data_ptr(), t=t32.data_ptr(), part=part.data_ptr(),
                 logz=logz.data_ptr(), tl=tl.data_ptr(), sx=x.stride(0), sw=W.stride(0),
                 N=N, D=D, V=V, valid_vocab=valid, n_split=n_split)
    from neko_tpu_torch.ops.cuda_build import load_library

    fn = load_library("fused_logz_tl").fused_logz_tl
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_logz_tl kernel launch failed: cudaError_t {err} "
                           f"(N={N}, D={D}, V={V})")
    fused_logz_tl.launches += 1
    return logz, tl


fused_logz_tl.launches = 0
