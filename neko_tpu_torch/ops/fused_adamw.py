"""Single-pass fused AdamW: the Hopper kernel and its plain version
(counterpart of neko_tpu/ops/fused_adamw.py).

One elementwise pass per parameter reads (p, g, mu, nu) and writes
(p', mu', nu') in place:

    g'  = g * clip_scale
    mu' = b1 * mu + (1 - b1) * g'
    nu' = b2 * nu + (1 - b2) * g'^2
    p'  = p - lr * (mu' / bc1 / (sqrt(nu' / bc2) + eps) + wd * p)

with bc1 = 1 - b1^t, bc2 = 1 - b2^t at t = count + 1 (optax.adamw's formula,
the JAX package's `fused_adamw_update`), and clip_scale =
min(1, max_norm / max(norm, 1e-16)) from the global gradient norm
(optax.clip_by_global_norm).

* `fused_adamw_apply(params, grads, mu, nu, scale, ...)`: the update with a
  given clip scale (a device scalar).  A CUDA tensor launches kernel #16
  (`csrc/fused_adamw.cu`), ONE launch over every parameter, and counts it in
  `fused_adamw_apply.launches`; a CPU tensor runs `_leaf_update_plain` per
  parameter.  No fallback on the card.
* `fused_adamw_update(params, grads, state, ...)`: the JAX signature over
  lists: bias corrections from the host count, the global norm and the clip
  scale on the device, then `fused_adamw_apply`.  Returns the state with
  count + 1.  Nothing syncs with the host: lr, bc1 and bc2 are host floats
  and the kernel reads the clip scale through a pointer, as the TPU kernel
  reads it from SMEM.

A gradient of None (a parameter the step did not reach) is a zero gradient,
as in the JAX tree where every leaf has one: its moments decay and its
weight decays.  `torch.optim.AdamW` skips such a parameter instead.

The plain version rounds after every operation (no fused multiply-add), in
the kernel's order, and both divide by bc1 and bc2 as a multiplication by
their host reciprocals (torch's CUDA division by a scalar does so anyway),
so on the card the two agree to the last bit.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch


class FusedAdamWState(NamedTuple):
    count: int               # updates applied (optax.ScaleByAdamState.count)
    mu: List[torch.Tensor]   # fp32, one per parameter
    nu: List[torch.Tensor]


def global_norm(grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every (fp32) gradient, a device scalar."""
    norms = torch._foreach_norm([g for g in grads if g is not None])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_scale_from_norm(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm's scale: min(1, max_norm / max(norm, 1e-16))."""
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-16), max=1.0)


def bias_corrections(count: int, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) at t = count + 1, as host floats."""
    t = count + 1
    return 1.0 - b1 ** t, 1.0 - b2 ** t


def _leaf_update_plain(p, g, mu, nu, scale, lr, b1, b2, eps, wd, bc1, bc2) -> None:
    """One parameter in place, in the kernel's order of fp32 operations."""
    g = torch.zeros_like(p) if g is None else g.float() * scale
    mu.copy_(mu * b1 + g * (1.0 - b1))
    nu.copy_(nu * b2 + (g * g) * (1.0 - b2))
    upd = (mu * (1.0 / bc1)) / ((nu * (1.0 / bc2)).sqrt() + eps)
    p.copy_(p - (upd + p * wd) * lr)


def fused_adamw_apply_reference(params, grads, mu, nu, scale, *, lr, b1, b2, eps, wd,
                                bc1, bc2) -> None:
    """The plain version of kernel #16: `_leaf_update_plain` per parameter."""
    for p, g, m, v in zip(params, grads, mu, nu, strict=True):
        _leaf_update_plain(p, g, m, v, scale, lr, b1, b2, eps, wd, bc1, bc2)


_TILE = 4096  # elements a block updates at a time (csrc/fused_adamw.cu kTile)


class _Hyper(ctypes.Structure):
    """csrc/fused_adamw.cu `Hyper`, field for field."""
    _fields_ = [(n, ctypes.c_float) for n in
                ("lr", "b1", "one_minus_b1", "b2", "one_minus_b2", "eps", "wd", "inv_bc1",
                 "inv_bc2")]


def _check(params, grads, mu, nu, scale) -> None:
    dev = params[0].device
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu, strict=True)):
        for name, t in (("param", p), ("grad", g), ("mu", m), ("nu", v)):
            if t is None and name == "grad":
                continue
            if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} {i}: the kernel takes contiguous fp32 tensors on "
                                 f"{dev}, got {t.dtype} {t.device}")
            if t.shape != p.shape:
                raise ValueError(f"{name} {i}: shape {tuple(t.shape)}, param {tuple(p.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != 1 or scale.device != dev:
        raise ValueError(f"scale must be an fp32 scalar on {dev}")


def fused_adamw_apply(params, grads, mu, nu, scale, *, lr, b1, b2, eps, wd, bc1, bc2) -> None:
    """AdamW in place over lists of fp32 parameters and moments, with the
    clip `scale` (fp32 scalar tensor) and bias corrections bc1, bc2 given;
    grads may hold None (zero gradient).  CPU: the plain version; CUDA:
    kernel #16, one launch."""
    if not params:
        return
    dev = params[0].device
    if dev.type == "cpu":
        return fused_adamw_apply_reference(params, grads, mu, nu, scale, lr=lr, b1=b1, b2=b2,
                                           eps=eps, wd=wd, bc1=bc1, bc2=bc2)
    if dev.type != "cuda":
        raise ValueError(f"no fused_adamw for device {dev}")
    _check(params, grads, mu, nu, scale)
    from neko_tpu_torch.ops.cuda_build import load_library

    # The table of (p, g, mu, nu, n, tiles before the leaf) is rebuilt every step: zero_grad(set_to_none)
    # gives every gradient new storage.  It goes to the device by an async copy
    # from pinned memory on the current stream; torch's pinned-memory cache keeps
    # the host buffer until that copy has run, so nothing blocks.
    rows, tiles = [], 0
    for p, g, m, v in zip(params, grads, mu, nu):
        rows.append((p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(),
                     v.data_ptr(), p.numel(), tiles))
        tiles += -(-p.numel() // _TILE)
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    fn = load_library("fused_adamw").fused_adamw
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.POINTER(_Hyper), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    hyper = _Hyper(lr=lr, b1=b1, one_minus_b1=1.0 - b1, b2=b2, one_minus_b2=1.0 - b2,
                   eps=eps, wd=wd, inv_bc1=1.0 / bc1, inv_bc2=1.0 / bc2)
    with torch.cuda.device(dev):
        err = fn(table.data_ptr(), len(rows), tiles, _TILE, scale.data_ptr(),
                 ctypes.byref(hyper), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError_t {err} "
                           f"({len(rows)} tensors)")
    fused_adamw_apply.launches += 1


fused_adamw_apply.launches = 0


def fused_adamw_update(params, grads, state: FusedAdamWState, *, lr: float, b1: float,
                       b2: float, eps: float, wd: float,
                       max_norm: Optional[float] = None) -> FusedAdamWState:
    """One fused AdamW step over lists of parameters, in place.  -> the
    state with count + 1 (its mu and nu are updated in place)."""
    bc1, bc2 = bias_corrections(state.count, b1, b2)
    dev = params[0].device
    if max_norm is not None:
        scale = clip_scale_from_norm(global_norm(grads), max_norm)
    else:
        scale = torch.ones((), dtype=torch.float32, device=dev)
    fused_adamw_apply(params, grads, state.mu, state.nu, scale.reshape(()), lr=lr, b1=b1,
                      b2=b2, eps=eps, wd=wd, bc1=bc1, bc2=bc2)
    return state._replace(count=state.count + 1)


def init_fused_adamw_state(params) -> FusedAdamWState:
    """Zero fp32 moments beside every parameter, count 0."""
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]
    return FusedAdamWState(0, zeros, [z.clone() for z in zeros])
