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

`NekoModel(cfg, mesh)` on a mesh over ranks is one rank's model
(`convert.build_model` fills it): the embedding rows and the head's
columns split over 'model' (the vocabulary-parallel lookup; the loss over
this rank's block of the vocabulary, merged across 'model', its target
count summed over 'data'), the blocks tensor-parallel (transformer.py),
and under FSDP the root's 'data'-split leaves gathered at the forward's
start (`fsdp_gather`).  Over 'seq' ranks every part of the forward but the
attention's ring works on this rank's S / n columns of the whole rows the
batch holds (each 'seq' peer is given the same packed rows and keeps its
columns on the device): the token and patch embedding of those columns
(image patches whose slot lies in them; inner positions at their global
indices), the LayerNorms, MLP and dropout (ops/dropout.py keeps the
columns of the whole sequence's mask), and the loss of the targets
predicted there (ops/losses.py, the target count summed over 'data' and
'seq').  The attention gets the whole rows' key mask: its key window is
global.  Generation runs over 'model' too: `prefill`, `decode_step` and
`extend_step` on this rank's heads, their logits gathered over 'model'
(`_head`).  Over 'pipe' a rank's model holds its stage's layers,
`layers / pipe` of them (parallel/pipeline.py runs the schedule through
`embed`, the blocks and `loss_from_hidden`).
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
from neko_tpu_torch.ops import quant
from neko_tpu_torch.parallel.collectives import gather_logits, vocab_parallel_embedding
from neko_tpu_torch.parallel.mesh import AXES, axis, seq_axis_size


def seed_offset(mesh) -> int:
    """The attention seed's offset for this rank, applied on a mesh of
    more than one device: neko_tpu's + coordinate * (100,003 + i) for axis
    i of ('data', 'seq', 'model'); under a 'seq' axis its ring path's
    data * 100,003 + model * 100,004, the same on every 'seq' peer (the
    ring's masks are unique through their global rows and columns, so the
    ranks draw the one mask the one-device shards draw at that seed)."""
    if mesh is None or not mesh.on_ranks:
        return 0
    if seq_axis_size(mesh) > 1:
        return mesh.axis("data").index * 100_003 + mesh.axis("model").index * 100_004
    return sum(mesh.axis(name).index * (100_003 + i) for i, name in enumerate(AXES))


class NekoModel(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        # over ranks: the vocabulary (embedding rows, head columns) split over
        # 'model', the loss's target count summed over 'data'
        self.tp = axis(mesh, "model")
        self.data_axis = axis(mesh, "data")
        # over 'seq' ranks: this rank's columns of the sequence
        self.seq_axis = axis(mesh, "seq")
        # FSDP: the use-site gather of the root's 'data'-split leaves (the
        # blocks gather their own; parallel/sharding.py enable_fsdp)
        self.fsdp_gather = None
        self._gathered = False
        self.embed_token = nn.Embedding(cfg.padded_embed_rows // self.tp.size, D)
        self.image_embedding = (
            ImagePatchEmbedding(cfg) if cfg.max_patches > 0 else None
        )
        self.pos_embed_observation = (
            nn.Embedding(cfg.context_len, D) if cfg.use_pos_encoding else None
        )
        self.embed_dropout = Dropout(cfg.dropout)
        # over 'pipe': this stage's layers
        self.transformer = Transformer(cfg, self.tp, seed_offset(mesh),
                                       cfg.layers // axis(mesh, "pipe").size)
        self.predict_token = nn.Linear(D, cfg.padded_vocab_size // self.tp.size, bias=False)

    # ---------------------------------------------------------------- embed
    def columns(self, S: int):
        """(first column, columns) of this rank's block of a sequence of S
        (all of it off 'seq' ranks)."""
        seq = self.seq_axis
        if not seq.on:
            return 0, S
        if S % seq.size:
            raise ValueError(f"S={S} does not split over the mesh's {seq.size} 'seq' ranks")
        n = S // seq.size
        return seq.index * n, n

    def embed_batch(self, batch: PackedBatch,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token ids (+ patch scatter + inner positions) -> [B, S, D] in the
        activation dtype (over 'seq' ranks this rank's columns of it);
        `generator` samples the patch positions (train)."""
        B, S = batch.tokens.shape
        c0, n = self.columns(S)
        emb = self.embed_tokens(batch.tokens[:, c0:c0 + n])
        if batch.has_patches:
            if self.image_embedding is None:
                raise ValueError("batch carries image patches but max_patches == 0")
            p_emb = self.image_embedding(batch.patches, batch.patch_pos, generator)
            # unused pool entries carry (batch, slot) == (B, S), and entries
            # of other ranks' columns lie outside [0, n): route them to one
            # spare row that is dropped afterwards (no host sync)
            pb, sl = batch.patch_batch.long(), batch.patch_slot.long() - c0
            flat = torch.where((pb < B) & (sl >= 0) & (sl < n), pb * n + sl, B * n)
            D = emb.shape[-1]
            emb = torch.cat([emb.reshape(B * n, D), emb.new_zeros(1, D)])
            emb = emb.index_copy(0, flat, p_emb.to(emb.dtype))[:-1].reshape(B, n, D)
        if self.pos_embed_observation is not None:
            emb = emb + self._inner_pos(batch.inner_pos[:, c0:c0 + n], emb.dtype)
        return emb

    def embed(self, batch: PackedBatch,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`embed_batch` then the embedding dropout (train mode with a
        `generator`): what the first layer takes."""
        return self.embed_dropout(self.embed_batch(batch, generator), generator)

    def _inner_pos(self, inner_pos: torch.Tensor, dtype) -> torch.Tensor:
        idx = inner_pos.long().clamp(0, self.cfg.context_len - 1)
        pe = self.pos_embed_observation(idx).to(dtype)
        return torch.where((inner_pos >= 0)[..., None], pe, torch.zeros_like(pe))

    # -------------------------------------------------------------- forward
    def gathered_call(self, method, *args, **kw):
        """`method(*args, **kw)` (a method of this model) with the root's
        'data'-split leaves gathered under FSDP (their gradients
        reduce-scatter back to the shards); a plain call without FSDP."""
        if self.fsdp_gather is None or self._gathered:
            return method(*args, **kw)
        self._gathered = True
        try:
            params = {"model." + k: v for k, v in self.fsdp_gather().items()}
            return torch.func.functional_call(_Bound(self), params, (method, args, kw))
        finally:
            self._gathered = False

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
        if self.fsdp_gather is not None and not self._gathered:
            return self.gathered_call(self.forward, batch, train=train, compute_loss=compute_loss,
                                      return_logits=return_logits, generator=generator)
        g = generator if train else None
        if return_logits is None:
            return_logits = not compute_loss
        if return_logits and (self.tp.on or self.seq_axis.on):
            raise NotImplementedError("logits under tensor or sequence parallelism: the "
                                      "head's columns or the sequence are split over ranks")
        emb = self.embed(batch, g)
        # the attention's key window is global: the whole rows' mask
        hidden, _ = self.transformer(emb, batch.input_mask, mode="train", generator=g)
        logits = self._head(hidden) if return_logits else None
        if not compute_loss:
            return logits, None
        if return_logits:
            loss = masked_next_token_loss(
                logits, batch.tokens, batch.input_mask, batch.target_mask, self.cfg.vocab_size)
        else:
            loss = self.loss_from_hidden(hidden, batch)
        return logits, loss

    def loss_from_hidden(self, hidden: torch.Tensor, batch: PackedBatch) -> torch.Tensor:
        """The loss of the final hidden state (after ln_f) without logits:
        the gathered CE when the batch carries `loss_pos` / `loss_tgt`, else
        the chunked CE.  Over ranks this rank's part of the global mean."""
        V = self.cfg.vocab_size
        c0, _ = self.columns(batch.tokens.shape[1])
        count = (self.data_axis, self.seq_axis)
        if batch.loss_pos is not None:
            return gathered_masked_xent(
                hidden, self.predict_token.weight, batch.loss_pos, batch.loss_tgt, V,
                vocab_axis=self.tp, count_axis=count, col_offset=c0)
        return chunked_masked_xent(
            hidden, self.predict_token.weight, batch.tokens, batch.input_mask,
            batch.target_mask, V, vocab_axis=self.tp, count_axis=count, col_offset=c0)

    # -------------------------------------------------------------- decode
    def _head(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits over the padded vocabulary; over 'model' the ranks'
        blocks gathered (padded columns included) before anything reads
        them, so every rank filters and samples the same bits."""
        w = quant.weight(self.predict_token, hidden.dtype)
        logits = torch.nn.functional.linear(hidden, w)
        return gather_logits(logits, self.tp).float()

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

    def extend_step(
        self,
        emb: torch.Tensor,
        start: torch.Tensor,
        clear_start: Optional[torch.Tensor] = None,
        clear_len: int = 0,
        buffer_len: int = 0,
        caches: Optional[List[KVCache]] = None,
    ) -> torch.Tensor:
        """Chunked append into the KV caches: emb [B, K, D] of the new
        tokens, start int [B] the position of chunk token 0.  Updates
        `caches` in place.  Returns fp32 logits [B, K, V].

        clear_start given: RING mode (the rollout cache); the timestep slot
        at clear_start (clear_len tokens) is evicted first, and token i lands
        at (start + i) % buffer_len.  clear_start None: APPEND mode
        (speculative verify rounds); token i lands at start + i and attends
        every column <= start + i.  It needs right-padded prompts, no context
        overflow, and rounds whose writes cover the previous round's
        rejected tail; the cache mask is not maintained."""
        hidden, _ = self.transformer(
            emb, None, mode="extend", caches=caches, decode_index=start.long(),
            extend_clear=(None if clear_start is None
                          else (clear_start, clear_len, buffer_len)),
        )
        return self._head(hidden)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Plain token-id embedding in the activation dtype (decode loop
        helper); over 'model' the lookup in this rank's rows, summed."""
        if self.tp.on:
            return vocab_parallel_embedding(tokens.long(), self.embed_token.weight,
                                            self.tp).to(self.cfg.activation_dtype)
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


class _Bound(nn.Module):
    """Holds a model so that `functional_call` swaps its leaves around a
    call of one of its methods."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, method, args, kw):
        return method(*args, **kw)


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
