"""Exact-formulation GELU x * Phi(x) via the Abramowitz & Stegun 7.1.26 erf
(counterpart of neko_tpu/ops/gelu.py, forward only).

The same rational approximation as the JAX package (|erf error| <= 1.5e-7),
so both packages compute the same activation to fp32 rounding.  The backward
(which the JAX package saves from the forward) comes with the training port.
"""

from __future__ import annotations

import torch

_P = 0.3275911
_A1 = 0.254829592
_A2 = -0.284496736
_A3 = 1.421413741
_A4 = -1.453152027
_A5 = 1.061405429
_INV_SQRT2 = 0.7071067811865476


def erf_approx(z: torch.Tensor) -> torch.Tensor:
    """A&S 7.1.26 erf, fp32 internals."""
    z32 = z.float()
    a = z32.abs()
    t = 1.0 / (1.0 + _P * a)
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    return torch.sign(z32) * (1.0 - poly * torch.exp(-a * a))


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """x * Phi(x) through the fast erf, computed in fp32; returns x.dtype."""
    x32 = x.float()
    cdf = 0.5 * (1.0 + erf_approx(x32 * _INV_SQRT2))
    return (x32 * cdf).to(x.dtype)
