"""NekoModel: the multimodal generalist policy, serving half (counterpart of
neko_tpu/models/policy.py).

* one shared embedding table over text+continuous+discrete ids plus the
  separator row, padded to `padded_embed_rows` exactly as in the JAX package
* image patches embedded by the ResNetV2 block + projection and scattered
  into their token slots
* learned inner-timestep position embedding on observation tokens only
* untied LM head `predict_token` (no bias) over `padded_vocab_size` columns

Submodule names follow the flax parameter tree, so `convert.py` maps one to
the other by name.  Losses and the training forward come with the training
port.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.data.batch import PackedBatch
from neko_tpu_torch.models.embeddings import ImagePatchEmbedding
from neko_tpu_torch.models.transformer import KVCache, Transformer


class NekoModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.embed_token = nn.Embedding(cfg.padded_embed_rows, D)
        self.image_embedding = (
            ImagePatchEmbedding(cfg) if cfg.max_patches > 0 else None
        )
        self.pos_embed_observation = (
            nn.Embedding(cfg.context_len, D) if cfg.use_pos_encoding else None
        )
        self.transformer = Transformer(cfg)
        self.predict_token = nn.Linear(D, cfg.padded_vocab_size, bias=False)

    # ---------------------------------------------------------------- embed
    def embed_batch(self, batch: PackedBatch) -> torch.Tensor:
        """Token ids (+ patch scatter + inner positions) -> [B, S, D]."""
        B, S = batch.tokens.shape
        emb = self.embed_token(batch.tokens.long())
        if batch.has_patches:
            if self.image_embedding is None:
                raise ValueError("batch carries image patches but max_patches == 0")
            p_emb = self.image_embedding(batch.patches, batch.patch_pos)
            # unused pool entries carry (batch, slot) == (B, S): route them to
            # one spare row that is dropped afterwards (no host sync)
            pb, sl = batch.patch_batch.long(), batch.patch_slot.long()
            flat = torch.where((pb < B) & (sl < S), pb * S + sl, B * S)
            D = emb.shape[-1]
            emb = torch.cat([emb.reshape(B * S, D), emb.new_zeros(1, D)])
            emb = emb.index_copy(0, flat, p_emb.to(emb.dtype))[:-1].reshape(B, S, D)
        if self.pos_embed_observation is not None:
            emb = emb + self._inner_pos(batch.inner_pos, emb.dtype)
        return emb

    def _inner_pos(self, inner_pos: torch.Tensor, dtype) -> torch.Tensor:
        idx = inner_pos.long().clamp(0, self.cfg.context_len - 1)
        pe = self.pos_embed_observation(idx).to(dtype)
        return torch.where((inner_pos >= 0)[..., None], pe, torch.zeros_like(pe))

    # -------------------------------------------------------------- decode
    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.predict_token(hidden).float()

    def prefill(
        self,
        emb: torch.Tensor,
        input_mask: torch.Tensor,
        last: Optional[torch.Tensor] = None,
    ):
        """Full forward populating the KV caches.

        Returns (fp32 logits [B, S, V], caches).  With `last` (int [B]) the
        head runs only at position last[b] of each row and the logits are
        [B, V]: generation reads nothing else, and the full [B, S, V] fp32
        logits are 1.7 GB at the flagship batch of 8."""
        hidden, caches = self.transformer(emb, input_mask, mode="prefill")
        if last is not None:
            rows = torch.arange(hidden.shape[0], device=hidden.device)
            hidden = hidden[rows, last.long()]
        return self._head(hidden), caches

    def decode_step(
        self,
        emb: torch.Tensor,
        decode_index: torch.Tensor,
        caches: List[KVCache],
    ) -> torch.Tensor:
        """One-token decode: emb [B, 1, D] of the new token, decode_index
        int [B] the cache position it is written to.  Updates `caches` in
        place and returns fp32 logits [B, 1, V]."""
        hidden, _ = self.transformer(
            emb, None, mode="decode", caches=caches,
            decode_index=decode_index.long(),
        )
        return self._head(hidden)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Plain token-id embedding (decode loop helper)."""
        return self.embed_token(tokens.long())

    def embed_tokens_with_pos(
        self, tokens: torch.Tensor, pos: torch.Tensor
    ) -> torch.Tensor:
        """Token embedding + inner-timestep position (decode loop helper for
        generation that continues inner positions)."""
        e = self.embed_token(tokens.long())
        if self.pos_embed_observation is not None:
            e = e + self._inner_pos(pos, e.dtype)
        return e
