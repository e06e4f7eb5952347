"""Image patch embedding: ResNetV2 block per patch + 2-D patch positions
(counterpart of neko_tpu/models/embeddings.py).

The public functions take NHWC patches, as the JAX package does; the
convolutions run NCHW inside, and the projection flattens each patch back in
JAX's (row, col, channel) order so the converted projection weight applies
unchanged.  Computation runs in `cfg.dtype` with explicit casts of the
(fp32 when training) weights, as flax's `dtype=` does; GroupNorm reduces in
its weight's dtype.  With a `generator` (training) the patch positions are
sampled inside their intervals; without one they take the interval's mean.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.ops.gelu import gelu_erf


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    return F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype), padding=conv.padding)


class ResidualBlockV2(nn.Module):
    """GELU -> 3x3 conv (3->mid) -> GroupNorm -> GELU -> 3x3 conv (mid->3),
    residual.  Input and output NCHW, in the input's dtype."""

    def __init__(self, mid_channels: int = 128, num_groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, mid_channels, 3, padding=1)
        self.gn2 = nn.GroupNorm(num_groups, mid_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(mid_channels, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.gn2
        h = _conv(self.conv1, gelu_erf(x))
        h = F.group_norm(h.to(gn.weight.dtype), gn.num_groups, gn.weight, gn.bias,
                         gn.eps).to(x.dtype)
        return x + _conv(self.conv2, gelu_erf(h))


class PatchPosEncoding(nn.Module):
    """2-D learned patch positions from quantized intervals [lo, hi): with a
    generator a uniform integer in [lo, max(hi, lo + 1)) per axis (the JAX
    package's train mode), else the round-half-even mean of the closed
    interval [lo, hi - 1]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.vocab = cfg.position_vocab_size
        self.height = nn.Embedding(cfg.position_vocab_size, cfg.embed_dim)
        self.width = nn.Embedding(cfg.position_vocab_size, cfg.embed_dim)

    @staticmethod
    def sample(lo: torch.Tensor, hi: torch.Tensor, generator: torch.Generator):
        """Uniform integers in [lo, max(hi, lo + 1)) from `generator` (the
        modulo bias of 30 random bits over <= 128 values is below 1e-7)."""
        bits = torch.randint(0, 1 << 30, lo.shape, device=lo.device, generator=generator)
        return lo + bits % torch.clamp(hi - lo, min=1)

    def forward(self, patch_pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = patch_pos.long()
        if generator is None:
            # torch.round rounds half to even, as jnp.round does
            h_idx = torch.round((p[..., 0] + p[..., 1] - 1) / 2.0).long()
            w_idx = torch.round((p[..., 2] + p[..., 3] - 1) / 2.0).long()
        else:
            h_idx = self.sample(p[..., 0], p[..., 1], generator)
            w_idx = self.sample(p[..., 2], p[..., 3], generator)
        return (self.height(h_idx.clamp(0, self.vocab - 1))
                + self.width(w_idx.clamp(0, self.vocab - 1)))


class ImagePatchEmbedding(nn.Module):
    """Embed raw patches [N, ps, ps, 3] (0..255, NHWC) -> [N, embed_dim]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        ps = cfg.patch_size
        self.residual_block = ResidualBlockV2(cfg.resid_mid_channels, cfg.num_groups)
        self.projection = nn.Linear(ps * ps * 3, cfg.embed_dim)
        self.pos_encoding = (
            PatchPosEncoding(cfg) if cfg.use_patch_pos_encoding else None
        )

    def forward(self, patches: torch.Tensor, patch_pos: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        N, ps = patches.shape[0], patches.shape[1]
        dtype = self.cfg.activation_dtype
        # [0,255] -> [-1,1], then / sqrt(patch_size)
        x = patches.to(dtype)
        x = (x / 255.0 * 2.0 - 1.0) / math.sqrt(ps)
        x = self.residual_block(x.permute(0, 3, 1, 2))  # NCHW inside
        x = x.permute(0, 2, 3, 1).reshape(N, ps * ps * 3)  # (p1, p2, c) order
        proj = self.projection
        x = F.linear(x, proj.weight.to(dtype), proj.bias.to(dtype))
        if self.pos_encoding is not None:
            x = x + self.pos_encoding(patch_pos, generator).to(dtype)
        return x
