"""NekoModel: the multimodal generalist policy (counterpart of
neko_tpu/models/policy.py).

* one shared embedding table over text+continuous+discrete ids plus the
  separator row, padded to `padded_embed_rows` exactly as in the JAX package
* image patches embedded by the ResNetV2 block + projection and scattered
  into their token slots
* learned inner-timestep position embedding on observation tokens only
* untied LM head `predict_token` (no bias) over `padded_vocab_size` columns
* `forward(batch, train=, compute_loss=, return_logits=, generator=)`: the
  JAX package's `__call__`, with embedding dropout and the three loss
  routes: dense logits (`masked_next_token_loss`), the gathered CE when the
  batch carries `loss_pos` / `loss_tgt`, else the chunked CE (ops/losses.py).
  `train=True` draws every random number (dropout masks, attention seeds,
  patch positions) from `generator`, the step's `torch.Generator`.

Submodule names follow the flax parameter tree, so `convert.py` maps one to
the other by name.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.data.batch import PackedBatch
from neko_tpu_torch.models.embeddings import ImagePatchEmbedding
from neko_tpu_torch.models.transformer import KVCache, Transformer
from neko_tpu_torch.ops.dropout import Dropout
from neko_tpu_torch.ops.losses import chunked_masked_xent, gathered_masked_xent


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
        self.embed_dropout = Dropout(cfg.dropout)
        self.transformer = Transformer(cfg)
        self.predict_token = nn.Linear(D, cfg.padded_vocab_size, bias=False)

    # ---------------------------------------------------------------- embed
    def embed_batch(self, batch: PackedBatch,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids (+ patch scatter + inner positions) -> [B, S, D] in the
        activation dtype; `generator` samples the patch positions (train)."""
        B, S = batch.tokens.shape
        emb = self.embed_tokens(batch.tokens)
        if batch.has_patches:
            if self.image_embedding is None:
                raise ValueError("batch carries image patches but max_patches == 0")
            p_emb = self.image_embedding(batch.patches, batch.patch_pos, generator)
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

    # -------------------------------------------------------------- forward
    def forward(
        self,
        batch: PackedBatch,
        *,
        train: bool = False,
        compute_loss: bool = False,
        return_logits: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """-> (fp32 logits [B, S, V] or None, loss or None).

        When compute_loss=True and logits are not requested, the loss comes
        from the gathered or chunked CE and the [B, S, V] logits are never
        materialized."""
        if train and generator is None:
            raise ValueError("train=True draws its randomness from `generator`")
        g = generator if train else None
        if return_logits is None:
            return_logits = not compute_loss
        emb = self.embed_dropout(self.embed_batch(batch, g), g)
        hidden, _ = self.transformer(emb, batch.input_mask, mode="train", generator=g)
        logits = self._head(hidden) if return_logits else None
        if not compute_loss:
            return logits, None
        V = self.cfg.vocab_size
        if return_logits:
            loss = masked_next_token_loss(
                logits, batch.tokens, batch.input_mask, batch.target_mask, V)
        elif batch.loss_pos is not None:
            loss = gathered_masked_xent(
                hidden, self.predict_token.weight, batch.loss_pos, batch.loss_tgt, V)
        else:
            loss = chunked_masked_xent(
                hidden, self.predict_token.weight, batch.tokens, batch.input_mask,
                batch.target_mask, V)
        return logits, loss

    # -------------------------------------------------------------- decode
    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        w = self.predict_token.weight
        return torch.nn.functional.linear(hidden, w.to(hidden.dtype)).float()

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
        """Plain token-id embedding in the activation dtype (decode loop
        helper)."""
        return self.embed_token(tokens.long()).to(self.cfg.activation_dtype)

    def embed_tokens_with_pos(
        self, tokens: torch.Tensor, pos: torch.Tensor
    ) -> torch.Tensor:
        """Token embedding + inner-timestep position (decode loop helper for
        generation that continues inner positions)."""
        e = self.embed_tokens(tokens)
        if self.pos_embed_observation is not None:
            e = e + self._inner_pos(pos, e.dtype)
        return e


def masked_next_token_loss(
    logits: torch.Tensor,       # fp32 [B, S, V] (V may be vocab-padded)
    tokens: torch.Tensor,       # int [B, S]
    input_mask: torch.Tensor,   # bool [B, S]
    target_mask: torch.Tensor,  # bool [B, S]
    valid_vocab: Optional[int] = None,
) -> torch.Tensor:
    """Shifted masked CE, averaged over unmasked target tokens of the batch
    (the dense-logits route)."""
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        # exclude padded vocab columns from the partition function
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = logits.masked_fill(col >= valid_vocab, -1e30)
    loss_logits = logits[:, :-1]
    mask = input_mask[:, :-1].float() * target_mask[:, 1:].float()
    logz = torch.logsumexp(loss_logits, dim=-1)
    # masked positions may hold ids outside the scored vocabulary: clip for
    # the gather and zero with `where` (never `*`, which would carry a NaN)
    safe = tokens[:, 1:].long().clamp(0, loss_logits.shape[-1] - 1)
    target_logit = loss_logits.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(mask > 0, logz - target_logit, 0.0)
    return nll.sum() / mask.sum().clamp(min=1.0)
