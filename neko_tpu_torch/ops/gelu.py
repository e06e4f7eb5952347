"""Exact-formulation GELU x * Phi(x) via the Abramowitz & Stegun 7.1.26 erf
(counterpart of neko_tpu/ops/gelu.py), and the tanh approximation
('gelu_new', `gelu_tanh`) as jax's `nn.gelu(approximate=True)` computes it.

The same rational approximation as the JAX package (|erf error| <= 1.5e-7),
so both packages compute the same activation to fp32 rounding.

* `gelu_erf(x)`: on a CUDA tensor one launch of the hand-written kernel
  (`csrc/gelu_erf.cu`) each way, counted in `gelu_erf.launches`; on a CPU
  tensor the plain version (`gelu_erf_reference`,
  `gelu_erf_grad_reference`), which is also what the kernel is held to on
  the card.  No fallback on the card.  The JAX package has no Pallas kernel
  here: XLA fuses its jnp formula into one pass, which the kernel does by
  hand.
* Under autograd an `autograd.Function` saves the input x, in its own dtype,
  as its only residual, and the backward recomputes gelu'(x) = Phi(x) +
  x * phi(x) from it (phi's exp(-x^2/2) is the exponential the erf already
  evaluates): the JAX package's custom VJP (`_gelu_fwd` / `_gelu_bwd`) in
  its mathematics, with the input kept instead of the fp32 gelu'(x).

Both ways compute in fp32 and round once to the input's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_P = 0.3275911
_A1 = 0.254829592
_A2 = -0.284496736
_A3 = 1.421413741
_A4 = -1.453152027
_A5 = 1.061405429
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT2PI = 0.3989422804014327


def _cdf_and_exp(x32: torch.Tensor):
    """(Phi(x), exp(-x^2 / 2)) of an fp32 tensor, sharing one exp (JAX
    `_gelu_and_grad`); the kernel's order of operations."""
    a = x32.abs() * _INV_SQRT2
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    ex = torch.exp(-a * a)  # = exp(-x^2 / 2)
    return 0.5 * (1.0 + torch.sign(x32) * (1.0 - poly * ex)), ex


def gelu_erf_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain forward: x * Phi(x) in fp32, rounded to x.dtype."""
    x32 = x.float()
    return (x32 * _cdf_and_exp(x32)[0]).to(x.dtype)


def gelu_erf_grad_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain backward: g * (Phi(x) + x * phi(x)) in fp32, rounded to
    g.dtype."""
    x32 = x.float()
    cdf, ex = _cdf_and_exp(x32)
    return (g.float() * (cdf + x32 * (_INV_SQRT2PI * ex))).to(g.dtype)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/gelu_erf.cu


def _dense_alike(*tensors):
    """The tensors in one dense memory layout and an empty output in it:
    the first tensor's own where it is dense in some order of its dims and
    the others share its strides (the image block's NHWC patches seen as
    NCHW keep their layout, as torch's elementwise kernels keep it), else
    all contiguous.  An elementwise pass over the flat memory is then right."""
    out = torch.empty_like(tensors[0])  # the first's strides where it is dense
    if all(t.stride() == out.stride() for t in tensors):
        return tensors, out
    return ([t.contiguous() for t in tensors],
            torch.empty_like(tensors[0], memory_format=torch.contiguous_format))


def _launch(name: str, *tensors: torch.Tensor) -> torch.Tensor:
    """One launch of gelu_erf_fwd (x) or gelu_erf_bwd (x, g) over the flat
    memory of the tensors; -> a new tensor of x's shape and dtype."""
    x = tensors[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"the gelu_erf kernel takes float32 or bfloat16, got {x.dtype}")
    for g in tensors[1:]:
        if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
            raise ValueError(f"gradient {g.dtype} {tuple(g.shape)} on {g.device} against "
                             f"input {x.dtype} {tuple(x.shape)} on {x.device}")
    from neko_tpu_torch.ops.cuda_build import load_library

    tensors, out = _dense_alike(*tensors)
    fn = getattr(load_library("gelu_erf"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * (len(tensors) + 1) + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err} "
                           f"({x.dtype} {tuple(x.shape)})")
    gelu_erf.launches += 1
    return out


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return gelu_erf_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"no gelu_erf for device {x.device}")
    return _launch("gelu_erf_fwd", x)


def _backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return gelu_erf_grad_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"no gelu_erf for device {x.device}")
    return _launch("gelu_erf_bwd", x, g)


class _GeluErf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _backward(x, g)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """x * Phi(x) through the fast erf, computed in fp32; returns x.dtype.
    CUDA: one kernel launch each way; CPU: the plain version."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluErf.apply(x)
    return _forward(x)


gelu_erf.launches = 0  # kernel launches, forward and backward, on CUDA tensors


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), in x's dtype."""
    return F.gelu(x, approximate="tanh")
