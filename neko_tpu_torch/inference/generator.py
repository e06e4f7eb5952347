"""KV-cache autoregressive generation (counterpart of
neko_tpu/inference/generator.py: batched generation and control).

One prefill over the right-padded prompts (through the whole-head attention
kernel on the card), then one single-token decode step per generated token.
The JAX package runs the decode steps as one compiled `lax.scan`; here they
are a Python loop over `NekoModel.decode_step`, which queues device work
without waiting for it (the tokens are read back once, at the end).

Semantics kept from the JAX package:

* logits restricted to the modality's legal token range [start, end] before
  argmax or sampling, with optional per-step sub-ranges (MultiDiscrete)
* greedy picks the first maximum; sampling applies temperature -> top-k ->
  top-p and draws from a `torch.Generator` (the caller's, or the instance's
  stream seeded at construction) -- the draws differ from jax.random's
* generated tokens are appended as plain embeddings, or with continuing
  inner positions (`inner_pos_continuation`)
* when a row would overflow the context, decode writes token i at
  `pos % context_len`: a ring over the cache that evicts the oldest token
* continuous actions decoded with the uniform-bin inverse
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from neko_tpu_torch.data.batch import to_device_batch
from neko_tpu_torch.data.packing import SequencePacker
from neko_tpu_torch.models.policy import NekoModel
from neko_tpu_torch.tokenizers.continuous import decode_np


def apply_logit_filters(window: torch.Tensor, *, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Serving-time logit warps on the last axis: temperature -> top-k ->
    top-p (nucleus).  Returns warped logits for SAMPLING only.

    top-p keeps the minimal descending-probability prefix whose cumulative
    mass reaches `top_p` (the most likely token is always kept); ties at the
    cut keep every tied logit."""
    if temperature != 1.0:
        window = window / temperature
    W = window.shape[-1]
    if top_k and top_k < W:
        kth = torch.topk(window, top_k, dim=-1).values[..., -1:]
        window = window.masked_fill(window < kth, -torch.inf)
    if top_p < 1.0:
        desc = torch.sort(window, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p  # prefix BEFORE this token < p => keep
        thresh = torch.where(keep, desc, torch.inf).min(dim=-1, keepdim=True).values
        window = window.masked_fill(window < thresh, -torch.inf)
    return window


def _check_sampling_args(temperature, top_k, top_p) -> None:
    if not temperature > 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not top_k >= 0:
        raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _resolve_sampling(defaults, temperature, top_k, top_p):
    """Per-call knobs (None = inherit the Generator-level defaults)."""
    t = defaults[0] if temperature is None else temperature
    k = defaults[1] if top_k is None else top_k
    p = defaults[2] if top_p is None else top_p
    _check_sampling_args(t, k, p)
    return float(t), int(k), float(p)


class Generator:
    def __init__(
        self,
        model: NekoModel,
        packer: Optional[SequencePacker] = None,
        *,
        seed: int = 0,
        temperature: float = 1.0,
        top_k: int = 0,
        top_p: float = 1.0,
    ):
        """`model` holds the weights and sits on the device generation runs
        on.  The serve cast is applied to it in place: every floating weight
        is cast to the config's activation dtype, as the JAX Generator's
        `_maybe_cast` serves from an activation-dtype copy (a no-op for fp32
        configs).  `temperature`/`top_k`/`top_p` are the default sampling
        knobs; per-call arguments override them."""
        self.model = model.eval()
        self.cfg = model.cfg
        _check_sampling_args(temperature, top_k, top_p)
        self._default_sampling = (temperature, top_k, top_p)
        self.packer = packer or SequencePacker(model.cfg)
        model.to(self.cfg.activation_dtype)
        self.device = next(model.parameters()).device
        # persistent sampling stream: calls without a generator still get
        # fresh draws each time
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)

    # ------------------------------------------------------------- batched
    @torch.inference_mode()
    def generate_batch(
        self,
        examples: Sequence[Dict],
        *,
        max_new_tokens: int,
        start: int,
        end: int,
        deterministic: bool = True,
        drop_trailing: int = 0,
        generator: Optional[torch.Generator] = None,
        inner_pos_continuation: bool = False,
        return_logits: bool = True,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        step_limits: Optional[Sequence[int]] = None,
    ):
        """Generate for a batch of prompts in lockstep (right-padded prompts,
        per-row decode positions).  Returns (tokens int64 [N, T],
        window_logits fp32 [N, T, end-start+1]), or (tokens,) when
        return_logits=False.  All rows generate max_new_tokens."""
        temperature, top_k, top_p = _resolve_sampling(
            self._default_sampling, temperature, top_k, top_p
        )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if step_limits is not None and len(step_limits) != max_new_tokens:
            raise ValueError("step_limits needs one entry per generated token")
        model, dev = self.model, self.device
        S = self.cfg.context_len
        arrays = self.packer.pack_batch(examples, pad_side="right")
        lengths = arrays.pop("lengths") - drop_trailing
        next_pos = arrays["inner_pos"].max(axis=1) + 1  # [N]
        ring = int(lengths.max()) + max_new_tokens > S
        rng = self._rng if generator is None else generator

        emb = model.embed_batch(to_device_batch(arrays, dev))
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
        pos = torch.as_tensor(lengths, dtype=torch.long, device=dev)
        next_pos = torch.as_tensor(next_pos, dtype=torch.long, device=dev)
        last_logits, caches = model.prefill(emb, mask, last=pos - 1)  # [N, V]

        limits = (None if step_limits is None
                  else torch.as_tensor(list(step_limits), device=dev))
        cols = torch.arange(end - start + 1, device=dev)
        toks, windows = [], []
        for i in range(max_new_tokens):
            window = last_logits[:, start:end + 1]
            if limits is not None:
                # per-STEP legal sub-range (MultiDiscrete components)
                window = window.masked_fill(cols[None, :] >= limits[i], -torch.inf)
            if deterministic:
                tok = window.argmax(dim=-1)
            else:
                warped = apply_logit_filters(
                    window, temperature=temperature, top_k=top_k, top_p=top_p
                )
                probs = torch.softmax(warped, dim=-1)
                tok = torch.multinomial(probs, 1, generator=rng)[:, 0]
            tok = tok + start
            toks.append(tok)
            if return_logits:
                windows.append(window)
            if i == max_new_tokens - 1:
                break  # the last token's decode step would feed nothing
            if inner_pos_continuation:
                emb = model.embed_tokens_with_pos(tok[:, None], next_pos[:, None])
            else:
                emb = model.embed_tokens(tok[:, None])
            write_pos = pos % S if ring else pos
            last_logits = model.decode_step(emb, write_pos, caches)[:, 0]
            pos = pos + 1
            next_pos = next_pos + 1

        tokens = torch.stack(toks, dim=1).cpu().numpy().astype(np.int64)
        if not return_logits:
            return (tokens,)
        return tokens, torch.stack(windows, dim=1).float().cpu().numpy()

    # ------------------------------------------------------ task-level API
    def predict_control_batch(
        self,
        examples: Sequence[Dict],
        *,
        action_kind: str,
        action_tokens: int,
        num_actions: Optional[int] = None,
        action_nvec: Optional[Sequence[int]] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ):
        """Predict one action per example for its last (action-padded)
        timestep.  Returns a list: ints for discrete, int arrays for
        MultiDiscrete (`action_nvec`), float arrays for continuous."""
        ts = self.cfg.token_space
        start = ts.start(action_kind)
        end = ts.end(action_kind)
        limits = None
        if action_kind == "discrete":
            if action_nvec is not None:
                if len(action_nvec) != action_tokens:
                    raise ValueError("action_nvec needs one range per action token")
                end = start + int(max(action_nvec)) - 1
                limits = [int(n) for n in action_nvec]
            else:
                if action_tokens != 1 or num_actions is None:
                    raise ValueError(
                        "plain discrete actions need action_tokens=1 and num_actions"
                    )
                end = start + num_actions - 1
        (tokens,) = self.generate_batch(
            examples,
            max_new_tokens=action_tokens,
            start=start,
            end=end,
            deterministic=deterministic,
            drop_trailing=action_tokens,
            generator=generator,
            return_logits=False,
            temperature=temperature, top_k=top_k, top_p=top_p,
            step_limits=limits,
        )
        if action_kind == "discrete":
            if action_nvec is not None:
                return [np.asarray(t - start, np.int64) for t in tokens]
            return [int(t[0] - start) for t in tokens]
        return [
            decode_np(
                t.astype(np.int32),
                n_bins=ts.continuous_tokens,
                offset=ts.continuous_start,
            )
            for t in tokens
        ]
