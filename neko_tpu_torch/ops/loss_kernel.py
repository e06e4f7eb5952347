"""Fused loss-head forward: the Hopper kernel and its plain version
(counterpart of neko_tpu/ops/loss_kernel.py).

Per row of x [N, D], with the head weight W [V, D] (the torch layout: the
JAX kernel takes its transpose [D, V]): logz = logsumexp of the logits
x @ W^T over the columns < valid_vocab (the padded columns get a finite
-1e30 fill), and the logit of the row's target column, both fp32, without
materializing the [N, V] logits.

* `fused_logz_tl(x, t, W, valid_vocab)`: a CUDA tensor launches kernel #15
  (`csrc/fused_logz_tl.cu`: TMA k-slices into a shared-memory ring, the
  tile products on wgmma, an online logsumexp on the accumulator registers,
  a persistent grid over (row block, vocabulary range) items and a merge
  pass) and counts it in `fused_logz_tl.launches`; a CPU tensor runs the
  plain version.  No fallback on the card.
* `fused_logz_tl_reference`: the plain version, the logits in fp32 of the
  operands as given, masked, then torch's logsumexp and gather.
* `fused_supported(N, D, V, dtype)`: the shapes the kernel takes.
* `_chunk_logits`: a chunk's [N, V] logits in fp32 from operands in the
  hidden dtype, masked past `valid_vocab`: the plain version's product, and
  the loss's for its backward; `logits_logz_tl` their logsumexp and target
  column, the loss forward for chunks the kernel does not take.
* `_pick_vb`: the TPU kernel's vocabulary block (the largest 128-multiple
  <= 1536 that divides V).  The CUDA kernel walks 128-column tiles and masks
  a ragged V itself, so it needs none; kept for the parity of the record.

The port's loss forward runs this function for every shape
`fused_supported` accepts (`losses._ChunkNLL`): on the card the kernel,
which beats the cuBLAS product + logsumexp + gather that the loss ran
before; on the CPU the plain version, which computes what that route
computes there.  The JAX package's loss keeps XLA for the same function.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

_NEG = -1e30
_TILE_COLS = 128        # csrc/fused_logz_tl.cu BN
_SPLIT_TILES = 8        # most 128-column tiles a vocabulary range holds (one partial a row)
_ROW_PITCH = 8          # D % 8 == 0: a bf16 row is a whole number of 16-byte units (TMA)


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
    cores' input type here), D a multiple of 8 (TMA's 16-byte row pitch; a
    ragged last 64-deep slice reads zeros), any N and V."""
    return dtype == torch.bfloat16 and N > 0 and V > 0 and D > 0 and D % _ROW_PITCH == 0


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


def logits_logz_tl(x, t, W, valid_vocab: Optional[int] = None):
    """(logz, target logit) through the [N, V] logits: `_chunk_logits`,
    torch's logsumexp and gather.  -> fp32 [N] each."""
    logits = _chunk_logits(x, W, valid_vocab)
    return torch.logsumexp(logits, dim=-1), logits.gather(1, t.long()[:, None])[:, 0]


def fused_logz_tl_reference(x, t, W, valid_vocab: Optional[int] = None):
    """The plain version: the [N, V] logits in fp32 (padded columns -1e30),
    their logsumexp and the target column.  -> (logz, tl), fp32 [N] each.
    The product runs in fp32 on the operands as given (a product of two bf16
    values is exact in fp32), as the kernel accumulates it."""
    return logits_logz_tl(x.float(), t, W.float(), valid_vocab)


class _Args(ctypes.Structure):
    """csrc/fused_logz_tl.cu `LossArgs`, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("w", ctypes.c_void_p), ("t", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("logz", ctypes.c_void_p), ("tl", ctypes.c_void_p),
                ("sx", ctypes.c_longlong), ("sw", ctypes.c_longlong),
                ("N", ctypes.c_int), ("D", ctypes.c_int), ("V", ctypes.c_int),
                ("valid_vocab", ctypes.c_int), ("n_split", ctypes.c_int),
                ("split_tiles", ctypes.c_int)]  # split_tiles: set by the C entry from n_split


def _check(x, t, W) -> None:
    if x.dim() != 2 or W.dim() != 2 or x.shape[1] != W.shape[1]:
        raise ValueError(f"x must be [N, D] and W [V, D], got {tuple(x.shape)}, "
                         f"{tuple(W.shape)}")
    N, D = x.shape
    if x.dtype != W.dtype or not fused_supported(N, D, W.shape[0], x.dtype):
        raise ValueError(f"no kernel for N={N}, D={D}, V={W.shape[0]}, {x.dtype}/{W.dtype}: "
                         f"it takes bf16 x and W and D a multiple of {_ROW_PITCH}")
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
    # one partial (max, sum, target logit) per row and vocabulary range; the
    # C entry spreads the 128-column tiles evenly over the n_split ranges
    n_split = -(-V // (_TILE_COLS * _SPLIT_TILES))
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
