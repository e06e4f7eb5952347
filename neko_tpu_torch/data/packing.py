"""Host-side sequence packer: ragged modality dicts -> fixed-shape arrays.

The numpy route of neko_tpu/data/packing.py, which the JAX package tests as
the bit-exact equal of its C fast path.  Semantics:

* per-timestep interleave order
  [image | text | continuous_obs | discrete_obs | SEP | continuous_actions |
   discrete_actions]
* a text example is ONE timestep whose observation tokens are the BPE ids,
  with inner positions 0..L-1 and a trailing separator
* prediction targets: text tokens and actions
* inner-timestep positions cover observation tokens only
* mu-law companded bins for continuous observations, plain uniform bins for
  continuous actions, `+ discrete_start` offset for discrete values
* LEFT padding by default; `pad_side='right'` for the generator's KV-cache
  decode path, so generated tokens append at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.data.batch import add_loss_entries_np, empty_batch_np
from neko_tpu_torch.tokenizers.continuous import encode_np


@dataclasses.dataclass
class PackedExample:
    """One packed (unpadded) example."""

    tokens: np.ndarray       # i32 [L]
    target_mask: np.ndarray  # bool [L]
    inner_pos: np.ndarray    # i32 [L], -1 where inapplicable
    patches: np.ndarray      # [n_patches, ps, ps, 3] (cfg.patch_dtype)
    patch_pos: np.ndarray    # i32 [n_patches, 4]
    patch_slot: np.ndarray   # i32 [n_patches] (position within [0, L))

    @property
    def length(self) -> int:
        return int(self.tokens.shape[0])


def patch_position_intervals(n: int, position_vocab_size: int = 128):
    """Quantized (lo, hi) interval per patch index along one axis:
    linspace(0, 1, n+1) * vocab with a truncating cast (the JAX package's
    models/embeddings.py::patch_position_intervals)."""
    lin = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    q = (lin * position_vocab_size).astype(np.int32)
    return np.stack([q[:-1], q[1:]], axis=-1)  # [n, 2]


def extract_patches(images: np.ndarray, patch_size: int, dtype=np.float32):
    """[T, H, W, 3] -> ([T*n_h*n_w, ps, ps, 3], n_h, n_w), row-major patch
    order.  dtype np.uint8 rounds-and-clips pixel values to [0, 255]."""
    T, H, W, C = images.shape
    ps = patch_size
    if H % ps or W % ps:
        raise ValueError(
            f"image dims {H}x{W} must be multiples of the patch size {ps}"
        )
    n_h, n_w = H // ps, W // ps
    dtype = np.dtype(dtype)
    if dtype == np.uint8 and images.dtype != np.uint8:
        images = np.clip(np.rint(images), 0, 255).astype(np.uint8)
    x = images.reshape(T, n_h, ps, n_w, ps, C)
    x = x.transpose(0, 1, 3, 2, 4, 5).reshape(T * n_h * n_w, ps, ps, C)
    return np.ascontiguousarray(x, dtype=dtype), n_h, n_w


class SequencePacker:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.ts = cfg.token_space
        self.S = cfg.context_len
        self.ps = cfg.patch_size
        self.P = cfg.max_patches

    # ------------------------------------------------------------ example
    def pack_example(self, ex: Dict) -> PackedExample:
        ts = self.ts
        cfg = self.cfg

        text = ex.get("text")
        images = ex.get("images")
        cont_obs = ex.get("continuous_obs")
        disc_obs = ex.get("discrete_obs")
        cont_act = ex.get("continuous_actions")
        disc_act = ex.get("discrete_actions")

        T = None

        def _check_T(n):
            nonlocal T
            if T is None:
                T = n
            elif T != n:
                raise ValueError(
                    f"modalities disagree on timesteps: {T} vs {n}"
                )

        parts_tokens: List[np.ndarray] = []   # each [T, k]
        parts_target: List[np.ndarray] = []
        n_obs_tokens = 0

        patches = np.zeros((0, self.ps, self.ps, 3), cfg.patch_np_dtype)
        patch_pos = np.zeros((0, 4), np.int32)
        patches_per_ts = 0

        if images is not None:
            images = np.asarray(images)
            if images.ndim == 3:  # single image [H, W, 3]
                images = images[None]
            patches, n_h, n_w = extract_patches(
                images, self.ps, dtype=cfg.patch_np_dtype
            )
            _check_T(images.shape[0])
            patches_per_ts = n_h * n_w
            h_iv = patch_position_intervals(n_h, cfg.position_vocab_size)
            w_iv = patch_position_intervals(n_w, cfg.position_vocab_size)
            per_img = np.concatenate(
                [
                    np.repeat(h_iv, n_w, axis=0),   # row interval per patch
                    np.tile(w_iv, (n_h, 1)),        # col interval per patch
                ],
                axis=-1,
            ).astype(np.int32)                       # [n_h*n_w, 4]
            patch_pos = np.tile(per_img, (images.shape[0], 1))
            parts_tokens.append(
                np.zeros((images.shape[0], patches_per_ts), np.int32)
            )
            parts_target.append(
                np.zeros((images.shape[0], patches_per_ts), bool)
            )
            n_obs_tokens += patches_per_ts

        if text is not None:
            text = np.asarray(text, dtype=np.int32)
            if text.ndim == 1:
                text = text[None]  # one timestep of L tokens
            # keep room for the trailing separator within the context
            max_text = self.S - 1
            if text.shape[1] > max_text:
                text = text[:, :max_text]
            _check_T(text.shape[0])
            parts_tokens.append(text)
            parts_target.append(np.ones_like(text, dtype=bool))
            n_obs_tokens += text.shape[1]

        # obs tokens are targets only under cfg.observation_loss
        obs_tgt = bool(cfg.observation_loss)
        if cont_obs is not None:
            cont_obs = np.asarray(cont_obs, dtype=np.float32)
            toks = encode_np(
                cont_obs,
                use_mu_law=True,
                mu=cfg.mu,
                M=cfg.M,
                n_bins=ts.continuous_tokens,
                offset=ts.continuous_start,
            )
            _check_T(toks.shape[0])
            parts_tokens.append(toks)
            parts_target.append(np.full_like(toks, obs_tgt, dtype=bool))
            n_obs_tokens += toks.shape[1]

        if disc_obs is not None:
            disc_obs = np.asarray(disc_obs, dtype=np.int32)
            if disc_obs.ndim == 1:
                disc_obs = disc_obs[:, None]
            toks = disc_obs + ts.discrete_start
            _check_T(toks.shape[0])
            parts_tokens.append(toks)
            parts_target.append(np.full_like(toks, obs_tgt, dtype=bool))
            n_obs_tokens += toks.shape[1]

        # T may also be determined by action-only examples
        for m in (cont_act, disc_act):
            if T is None and m is not None:
                T = np.asarray(m).shape[0] if np.asarray(m).ndim > 0 else 1
        if T is None:
            raise ValueError("example has no modality data")

        # separator
        parts_tokens.append(np.full((T, 1), ts.separator_id, np.int32))
        parts_target.append(np.zeros((T, 1), bool))

        if cont_act is not None:
            cont_act = np.asarray(cont_act, dtype=np.float32)
            toks = encode_np(
                cont_act,
                use_mu_law=False,
                mu=cfg.mu,
                M=cfg.M,
                n_bins=ts.continuous_tokens,
                offset=ts.continuous_start,
            )
            _check_T(toks.shape[0])
            parts_tokens.append(toks)
            parts_target.append(np.ones_like(toks, dtype=bool))

        if disc_act is not None:
            disc_act = np.asarray(disc_act, dtype=np.int32)
            if disc_act.ndim == 1:
                disc_act = disc_act[:, None]
            toks = disc_act + ts.discrete_start
            _check_T(toks.shape[0])
            parts_tokens.append(toks)
            parts_target.append(np.ones_like(toks, dtype=bool))

        tokens_ts = np.concatenate(parts_tokens, axis=1)  # [T, k]
        target_ts = np.concatenate(parts_target, axis=1)
        k = tokens_ts.shape[1]

        inner = np.full((T, k), -1, np.int32)
        inner[:, :n_obs_tokens] = np.arange(n_obs_tokens, dtype=np.int32)[None]

        tokens = tokens_ts.reshape(-1)
        target = target_ts.reshape(-1)
        inner_pos = inner.reshape(-1)
        # flat slot of patch j of timestep t is t*k + j
        patch_slot = (
            np.arange(T, dtype=np.int32)[:, None] * k
            + np.arange(patches_per_ts, dtype=np.int32)[None, :]
        ).reshape(-1)

        # Truncate oldest timesteps if over budget.
        L = tokens.shape[0]
        if L > self.S:
            drop_ts = -(-(L - self.S) // k)  # ceil in timesteps
            if drop_ts >= T:
                raise ValueError(
                    f"a single timestep of {k} tokens cannot fit the "
                    f"context ({self.S}); shorten the text/patch content"
                )
            keep_from = drop_ts * k
            tokens = tokens[keep_from:]
            target = target[keep_from:]
            inner_pos = inner_pos[keep_from:]
            keep_patches = patch_slot >= keep_from
            patches = patches[keep_patches]
            patch_pos = patch_pos[keep_patches]
            patch_slot = patch_slot[keep_patches] - keep_from

        return PackedExample(
            tokens=tokens.astype(np.int32),
            target_mask=target,
            inner_pos=inner_pos,
            patches=patches,
            patch_pos=patch_pos,
            patch_slot=patch_slot.astype(np.int32),
        )

    # -------------------------------------------------------------- batch
    def pack_batch(
        self,
        examples: Sequence[Dict],
        *,
        pad_side: str = "left",
        seq_len: Optional[int] = None,
        patch_budget: Optional[int] = None,
        target_budget: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Pack examples (dicts or PackedExamples) into one fixed-shape
        record (plus `lengths`).

        patch_budget: total image patches across the WHOLE batch (the global
        patch pool).  By default the pool holds B * max_patches, grown in
        256-buckets if a batch needs more; training passes the exact count
        of its mixture.  target_budget > 0 adds the gathered-loss entries
        (`loss_pos`, `loss_tgt`).  seq_len overrides the context length S.
        """
        if pad_side not in ("left", "right"):
            raise ValueError(f"pad_side must be 'left' or 'right', got {pad_side!r}")
        S = self.S if seq_len is None else seq_len
        B = len(examples)
        packed = [ex if isinstance(ex, PackedExample) else self.pack_example(ex)
                  for ex in examples]
        if patch_budget is None:
            needed = sum(pe.patches.shape[0] for pe in packed)
            N = B * self.P
            if needed > N:
                N = -(-needed // 256) * 256
        else:
            N = patch_budget
        out = empty_batch_np(B, S, N, self.ps, patch_dtype=self.cfg.patch_np_dtype)
        lengths = np.zeros(B, np.int32)
        n_used = 0

        for i, pe in enumerate(packed):
            L = pe.length
            if L > S:
                raise ValueError(f"packed example length {L} exceeds context {S}")
            n_p = pe.patches.shape[0]
            off = (S - L) if pad_side == "left" else 0
            sl = slice(off, off + L)
            out["tokens"][i, sl] = pe.tokens
            out["input_mask"][i, sl] = True
            out["target_mask"][i, sl] = pe.target_mask
            out["inner_pos"][i, sl] = pe.inner_pos
            if n_p:
                if n_used + n_p > N:
                    raise ValueError(
                        f"batch needs more than its {N} pooled image patches "
                        "(ModelConfig.max_patches or pack_batch(patch_budget=...))"
                    )
                pool = slice(n_used, n_used + n_p)
                out["patches"][pool] = pe.patches
                out["patch_pos"][pool] = pe.patch_pos
                out["patch_batch"][pool] = i
                out["patch_slot"][pool] = pe.patch_slot + off
                n_used += n_p
            lengths[i] = L
        if target_budget is not None and target_budget > 0:
            add_loss_entries_np(out, target_budget)
        out["lengths"] = lengths
        return out
