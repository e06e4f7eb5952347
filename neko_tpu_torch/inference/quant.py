"""fp8 (e4m3) weight-only quantization for serving (counterpart of
neko_tpu/inference/quant.py).

The large matmul weights are stored as float8_e4m3fn with one fp32 scale
per output channel and dequantized at the point of use (ops/quant.py, the
format and the read every matmul of the model makes): the weight bytes a
decode step reads from device memory halve again after the bf16 serve
cast.  The dequantize is a torch product before each matmul, so each use
writes a bf16 copy of its weight; a GEMV that reads the fp8 bytes itself
is later work.  A model takes a quantized state dict through
`convert.build_model` (on ranks too) or `convert.assign_state` (in place).

* Eligible, as neko_tpu decides: the 2-D weights of the Linear layers (the
  flax leaf `kernel`), at least `min_size` elements, none of LoRA's, never
  an embedding table (read by a gather).
* Scales: `amax` over each output row, `max(amax / 448, 1e-30)`; the stored
  value `clip(W / scale, ±448)` cast to e4m3 (no inf there: the clip keeps
  every value finite).
* Over a 'model' axis (parallel/sharding.py): the fp8 weight shards as its
  weight does; the scale along the output dim of a column-parallel layer
  (c_attn by heads, c_fc, gate, predict_token) and whole on every rank for
  a row-parallel one (c_proj), neko_tpu's `quant_pspec`.  The canonical
  (whole) weights are quantized first and then sharded, as neko_tpu places
  its quantized tree: a row-parallel shard quantized on its own would see
  half of each output row and get other scales.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from neko_tpu_torch.ops.quant import FP8, FP8_MAX, SCALE, dequantize, weight  # noqa: F401

WEIGHT_DTYPES = (None, "bf16", "fp8", "fp8_e4m3")


def wants_fp8(weight_dtype: Optional[str]) -> bool:
    """Validate a serving weight dtype (neko_tpu's choices); True for fp8."""
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(f"weight_dtype must be None/'bf16'/'fp8', got {weight_dtype!r}")
    return weight_dtype in ("fp8", "fp8_e4m3")


def eligible(key: str, t: torch.Tensor, min_size: int = 1024) -> bool:
    """Whether the state-dict entry `key` is a weight neko_tpu quantizes."""
    from neko_tpu_torch.convert import jax_leaf

    if not key.endswith(".weight") or t.dim() != 2 or t.numel() < min_size:
        return False
    path, _ = jax_leaf(key, 2)
    if path[-1] != "kernel" or any(m.startswith("lora") for m in path):
        return False
    return t.is_floating_point() and t.dtype != FP8


def quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A [out, in] weight -> (float8_e4m3fn [out, in], fp32 scales [out]).
    The divisor is a tensor on w's device: torch divides a CUDA tensor by a
    Python number as a product with its reciprocal, which rounds otherwise
    than neko_tpu's (and the CPU's) division."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=1) / wf.new_tensor(FP8_MAX), min=1e-30)
    q = torch.clamp(wf / scale[:, None], -FP8_MAX, FP8_MAX)
    return q.to(FP8), scale


def quantize_state_dict(sd: Dict[str, torch.Tensor], min_size: int = 1024
                        ) -> Dict[str, torch.Tensor]:
    """A (canonical) state dict with its eligible weights quantized: each
    such `<m>.weight` becomes fp8 and `<m>.qscale` joins it."""
    out = {}
    for key, t in sd.items():
        if eligible(key, t, min_size):
            q, s = quantize(t)
            out[key] = q
            out[key[:-len("weight")] + SCALE] = s
        else:
            out[key] = t
    return out


def is_quantized(model: nn.Module) -> bool:
    return any(name.endswith("." + SCALE) for name, _ in model.named_buffers())


def serve_cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer to `dtype` in place, but the
    fp8 weights and their fp32 scales (neko_tpu casts before it quantizes)."""
    for mod in model.modules():
        scaled = getattr(mod, SCALE, None) is not None
        for name, p in list(mod.named_parameters(recurse=False)):
            if p.is_floating_point() and p.dtype != dtype and not (scaled and name == "weight"):
                p.data = p.data.to(dtype)
        for name, b in list(mod.named_buffers(recurse=False)):
            if b.is_floating_point() and b.dtype != dtype and name != SCALE:
                setattr(mod, name, b.to(dtype))
    return model


def serve_cast_state_dict(sd: Dict[str, torch.Tensor], dtype: torch.dtype
                          ) -> Dict[str, torch.Tensor]:
    """`serve_cast` of a state dict (a copy where a tensor changes dtype)."""
    return {k: (t.to(dtype) if t.is_floating_point() else t) for k, t in sd.items()}


def quantized_bytes(sd_or_model) -> Tuple[int, int]:
    """(bytes of the quantized weights and their scales, bytes of all) of a
    (possibly) quantized model or state dict."""
    sd = sd_or_model.state_dict() if isinstance(sd_or_model, nn.Module) else sd_or_model
    qb = tb = 0
    for key, t in sd.items():
        n = t.numel() * t.element_size()
        tb += n
        if key.endswith("." + SCALE) or t.dtype == FP8:
            qb += n
    return qb, tb
