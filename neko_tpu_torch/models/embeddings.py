"""Image patch embedding: ResNetV2 block per patch + 2-D patch positions
(counterpart of neko_tpu/models/embeddings.py, eval mode).

The public functions take NHWC patches, as the JAX package does; the
convolutions run NCHW inside, and the projection flattens each patch back in
JAX's (row, col, channel) order so the converted projection weight applies
unchanged.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.ops.gelu import gelu_erf


class ResidualBlockV2(nn.Module):
    """GELU -> 3x3 conv (3->mid) -> GroupNorm -> GELU -> 3x3 conv (mid->3),
    residual.  Input and output NCHW."""

    def __init__(self, mid_channels: int = 128, num_groups: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, mid_channels, 3, padding=1)
        self.gn2 = nn.GroupNorm(num_groups, mid_channels, eps=1e-5)
        self.conv2 = nn.Conv2d(mid_channels, 3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(gelu_erf(x))
        h = self.conv2(gelu_erf(self.gn2(h)))
        return x + h


class PatchPosEncoding(nn.Module):
    """2-D learned patch positions from quantized intervals; eval mode uses
    the round-half-even mean of the closed interval [lo, hi-1]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.vocab = cfg.position_vocab_size
        self.height = nn.Embedding(cfg.position_vocab_size, cfg.embed_dim)
        self.width = nn.Embedding(cfg.position_vocab_size, cfg.embed_dim)

    def forward(self, patch_pos: torch.Tensor) -> torch.Tensor:
        p = patch_pos.long()
        # torch.round rounds half to even, as jnp.round does
        h_idx = torch.round((p[..., 0] + p[..., 1] - 1) / 2.0).long()
        w_idx = torch.round((p[..., 2] + p[..., 3] - 1) / 2.0).long()
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

    def forward(self, patches: torch.Tensor, patch_pos: torch.Tensor) -> torch.Tensor:
        N, ps = patches.shape[0], patches.shape[1]
        dtype = self.projection.weight.dtype
        # [0,255] -> [-1,1], then / sqrt(patch_size)
        x = patches.to(dtype)
        x = (x / 255.0 * 2.0 - 1.0) / math.sqrt(ps)
        x = self.residual_block(x.permute(0, 3, 1, 2))  # NCHW inside
        x = x.permute(0, 2, 3, 1).reshape(N, ps * ps * 3)  # (p1, p2, c) order
        x = self.projection(x)
        if self.pos_encoding is not None:
            x = x + self.pos_encoding(patch_pos).to(x.dtype)
        return x
