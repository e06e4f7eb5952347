"""Exact-formulation GELU x * Phi(x) via the Abramowitz & Stegun 7.1.26 erf
(counterpart of neko_tpu/ops/gelu.py), and the tanh approximation
('gelu_new', `gelu_tanh`) as jax's `nn.gelu(approximate=True)` computes it.

The same rational approximation as the JAX package (|erf error| <= 1.5e-7),
so both packages compute the same activation to fp32 rounding.  Under
autograd, `gelu_erf` is an `autograd.Function` that computes gelu'(x) =
Phi(x) + x * phi(x) in the forward (phi's exp(-x^2/2) is the exponential the
erf already evaluates) and saves it, in fp32, as its only residual, as the
JAX package's custom VJP (`_gelu_fwd` / `_gelu_bwd`) does.  Without a graph
(serving, no_grad) it computes the forward alone.
"""

from __future__ import annotations

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


def erf_approx(z: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 erf, fp32 internals."""
    z32 = z.float()
    a = z32.abs()
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    return torch.sign(z32) * (1.0 - poly * torch.exp(-a * a))


def _gelu_and_grad(x: torch.Tensor):
    """(gelu(x), gelu'(x)) in fp32, sharing one exp (JAX `_gelu_and_grad`)."""
    x32 = x.float()
    a = x32.abs() * _INV_SQRT2
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    ex = torch.exp(-a * a)  # = exp(-x^2 / 2)
    cdf = 0.5 * (1.0 + torch.sign(x32) * (1.0 - poly * ex))
    return x32 * cdf, cdf + x32 * (_INV_SQRT2PI * ex)


class _GeluErf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, dy = _gelu_and_grad(x)
        ctx.save_for_backward(dy)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (dy,) = ctx.saved_tensors
        return (g.float() * dy).to(g.dtype)


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """x * Phi(x) through the fast erf, computed in fp32; returns x.dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluErf.apply(x)
    x32 = x.float()
    cdf = 0.5 * (1.0 + erf_approx(x32 * _INV_SQRT2))
    return (x32 * cdf).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), in x's dtype."""
    return F.gelu(x, approximate="tanh")
