"""How the model reads an fp8 (e4m3) weight: the format of a quantized
Linear and its dequantize at the point of use.

A quantized Linear keeps its `weight` (float8_e4m3fn, [out, in]) and gains
a `qscale` buffer (fp32 [out], one scale per output channel); in a state
dict the scale is the entry `<module>.qscale` beside `<module>.weight`.
`weight(layer, dtype)` is what every matmul of the model reads: the
dequantize in the JAX package's order, `q.to(dtype) * s.to(dtype)`, then
the product in the activation dtype.  Quantizing, eligibility and the
serve cast are in inference/quant.py.
"""

from __future__ import annotations

import torch
from torch import nn

# float8_e4m3fn: the largest finite value (no inf; overflow is nan, hence the clip)
FP8_MAX = 448.0
FP8 = torch.float8_e4m3fn
SCALE = "qscale"  # the buffer / state-dict leaf of a quantized weight's scales


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's order: `q.astype(dtype) * s.astype(dtype)`, per
    output row."""
    return q.to(dtype) * scale.to(dtype)[:, None]


def weight(layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """`layer.weight` in `dtype`, dequantized when the layer is quantized."""
    scale = getattr(layer, SCALE, None)
    if scale is None:
        return layer.weight.to(dtype)
    return dequantize(layer.weight, scale, dtype)
