"""KV-cache autoregressive generation (counterpart of
neko_tpu/inference/generator.py: single and batched generation, the
task-level predict_* calls, control and the rollout cache).

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
* `targets` [N, T]: the per-token NLL of given target ids under the
  restricted window, computed on the device (text evaluation reads only
  those [N, T] floats)
* `generate` (one prompt, or a precomputed prompt embedding): the batched
  path when the prompt and its tokens fit the context, else a per-token
  loop that re-prefills the last context_len embeddings once the context is
  full (`exact_window`, the reference's sliding window);
  `predict_text` / `predict_response` / `predict_caption` /
  `predict_answer` on top of it; `num_beams > 1` (beam search) raises
  `NotYetPorted`
* `RolloutSession` (the rollout cache of control evaluation): the KV cache
  lives across env steps; each step ring-extends it with the new timestep's
  [obs | sep] tokens (`NekoModel.extend_step`, evicting the oldest timestep
  slot) and decodes the action tokens through the decode kernel, every
  generated token written into the cache

The Generator serves from the model it is given, cast in place to the
activation dtype: a caller that trains the weights hands it a copy
(`set_params` refreshes the copy from a state dict).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from neko_tpu_torch.data.batch import to_device_batch
from neko_tpu_torch.data.packing import SequencePacker
from neko_tpu_torch.models.policy import NekoModel
from neko_tpu_torch.tokenizers.continuous import decode_np


class NotYetPorted(ValueError):
    """A feature of the JAX package that neko_tpu_torch does not run yet."""


def _refuse_beams(num_beams: int) -> None:
    if num_beams > 1:
        raise NotYetPorted(f"beam search (num_beams={num_beams} > 1) is not yet ported to "
                           "neko_tpu_torch")


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


def _pick(window: torch.Tensor, deterministic: bool, rng, sampling) -> torch.Tensor:
    """Token index within `window` [N, W] per row: the first maximum, or a
    draw from the warped distribution."""
    if deterministic:
        return window.argmax(dim=-1)
    temperature, top_k, top_p = sampling
    warped = apply_logit_filters(window, temperature=temperature, top_k=top_k, top_p=top_p)
    return torch.multinomial(torch.softmax(warped, dim=-1), 1, generator=rng)[:, 0]


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

    @torch.no_grad()
    def set_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Copy weights (any dtype, any device) into the served model with
        the serve cast: the caller's tensors are read, never changed."""
        self.model.load_state_dict(state_dict)

    @torch.inference_mode()
    def _decode(self, last_logits, caches, pos, next_pos, *, n_steps: int, start: int,
                end: int, deterministic: bool, rng, with_pos: bool, ring: bool,
                limits=None, targets=None, return_logits: bool = True,
                feed_last: bool = False, sampling=(1.0, 0, 1.0)):
        """n_steps tokens restricted to [start, end] from `last_logits`
        [N, V]; each token but the last (every one with `feed_last`) goes
        through a decode step at `pos` (`pos % context_len` with `ring`).
        -> (tokens [N, T] on the device, window logits [N, T, W] or None,
        target NLL [N, T] or None)."""
        model, S = self.model, self.cfg.context_len
        cols = torch.arange(end - start + 1, device=last_logits.device)
        toks, windows, nlls = [], [], []
        for i in range(n_steps):
            window = last_logits[:, start:end + 1]
            if limits is not None:
                # per-STEP legal sub-range (MultiDiscrete components)
                window = window.masked_fill(cols[None, :] >= limits[i], -torch.inf)
            tok = _pick(window, deterministic, rng, sampling) + start
            toks.append(tok)
            if return_logits:
                windows.append(window)
            if targets is not None:
                tl = window.gather(1, targets[:, i:i + 1].long())[:, 0]
                nlls.append(torch.logsumexp(window, dim=-1) - tl)
            if i == n_steps - 1 and not feed_last:
                break  # the last token's decode step would feed nothing
            if with_pos:
                emb = model.embed_tokens_with_pos(tok[:, None], next_pos[:, None])
            else:
                emb = model.embed_tokens(tok[:, None])
            write_pos = pos % S if ring else pos
            last_logits = model.decode_step(emb, write_pos, caches)[:, 0]
            pos = pos + 1
            next_pos = next_pos + 1
        return (torch.stack(toks, dim=1),
                torch.stack(windows, dim=1) if return_logits else None,
                torch.stack(nlls, dim=1) if targets is not None else None)

    # ---------------------------------------------------------- one prompt
    @torch.inference_mode()
    def generate(
        self,
        example: Optional[Dict] = None,
        *,
        max_new_tokens: int,
        start: int,
        end: int,
        deterministic: bool = True,
        drop_trailing: int = 0,
        generator: Optional[torch.Generator] = None,
        prompt_emb: Optional[torch.Tensor] = None,
        prompt_len: Optional[int] = None,
        inner_pos_continuation: bool = False,
        exact_window: bool = False,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        step_limits: Optional[Sequence[int]] = None,
    ):
        """Generate tokens restricted to [start, end] for one prompt.

        Returns (token ids int64 [n], window logits fp32 [n, end-start+1]).
        Either pass `example` (packed here; `drop_trailing` tokens cut from
        its end) or a precomputed (`prompt_emb` [1, S, D], `prompt_len`).
        `inner_pos_continuation`: generated tokens embed with continuing
        inner-timestep positions (predict_response) instead of as plain
        tokens (predict_text / predict_control).  `step_limits` (one width
        per generated token): step i may only select [start, start +
        limits[i] - 1].

        An example that fits the context with its tokens runs as
        `generate_batch` of one row (so does an overflowing one: the ring
        decode).  `exact_window=True`, or a precomputed embedding, runs one
        token at a time instead, re-prefilling the last context_len
        embeddings for every token past the context: the reference's
        sliding window, exactly."""
        sampling = _resolve_sampling(self._default_sampling, temperature, top_k, top_p)
        S, model, dev = self.cfg.context_len, self.model, self.device
        next_pos = 0
        if prompt_emb is None:
            arrays = self.packer.pack_batch([example], pad_side="right")
            L = int(arrays.pop("lengths")[0]) - drop_trailing
            if L + max_new_tokens <= S or not exact_window:
                toks, windows = self.generate_batch(
                    [example], max_new_tokens=max_new_tokens, start=start, end=end,
                    deterministic=deterministic, drop_trailing=drop_trailing,
                    generator=generator, inner_pos_continuation=inner_pos_continuation,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    step_limits=step_limits)
                return toks[0], windows[0]
            next_pos = int(arrays["inner_pos"][0, :max(L, 1)].max()) + 1
            emb = model.embed_batch(to_device_batch(arrays, dev))
        else:
            emb, L = prompt_emb.to(dev), int(prompt_len)
        if step_limits is not None:
            raise ValueError("step_limits is not supported on the exact-window path "
                             "(control prompts always fit the context)")
        rng = self._rng if generator is None else generator

        mask = torch.arange(S, device=dev)[None, :] < L
        last_logits, caches = model.prefill(emb, mask, last=torch.tensor([L - 1], device=dev))
        out_tokens, out_logits = [], []
        pos = L
        for i in range(max_new_tokens):
            window = last_logits[:, start:end + 1]
            tok = _pick(window, deterministic, rng, sampling) + start  # [1]
            out_tokens.append(tok)
            out_logits.append(window[0])
            if i == max_new_tokens - 1:
                break
            if inner_pos_continuation:
                tok_emb = model.embed_tokens_with_pos(
                    tok[:, None], torch.full((1, 1), next_pos + i, device=dev))
            else:
                tok_emb = model.embed_tokens(tok[:, None])
            if pos >= S:
                # slide the window: re-prefill on the last S - 1 embeddings
                emb = torch.cat([emb[:, 1:], tok_emb], dim=1)
                last_logits, caches = model.prefill(
                    emb, torch.ones(1, S, dtype=torch.bool, device=dev),
                    last=torch.tensor([S - 1], device=dev))
                continue
            last_logits = model.decode_step(
                tok_emb, torch.tensor([pos], device=dev), caches)[:, 0]
            # the embedding stream stays in sync for later slides
            emb = emb.clone()
            emb[:, pos] = tok_emb[:, 0]
            pos += 1
        return (torch.cat(out_tokens).cpu().numpy().astype(np.int64),
                torch.stack(out_logits).float().cpu().numpy())

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
        targets: Optional[np.ndarray] = None,
        return_logits: bool = True,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        step_limits: Optional[Sequence[int]] = None,
    ):
        """Generate for a batch of prompts in lockstep (right-padded prompts,
        per-row decode positions).  Returns (tokens int64 [N, T][,
        window_logits fp32 [N, T, end-start+1]][, target NLL fp32 [N, T]]):
        the logits when return_logits, the NLL of `targets` (ids within the
        window, int [N, T]) when given.  All rows generate max_new_tokens."""
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
        tgt = None if targets is None else torch.as_tensor(np.asarray(targets), device=dev)
        toks, windows, nlls = self._decode(
            last_logits, caches, pos, next_pos, n_steps=max_new_tokens, start=start, end=end,
            deterministic=deterministic, rng=rng, with_pos=inner_pos_continuation, ring=ring,
            limits=limits, targets=tgt, return_logits=return_logits,
            sampling=(temperature, top_k, top_p))
        out = [toks.cpu().numpy().astype(np.int64)]
        for y in (windows, nlls):
            if y is not None:
                out.append(y.float().cpu().numpy())
        return tuple(out)

    # ------------------------------------------------------ task-level API
    def predict_text(
        self,
        example: Dict,
        max_length: int = 20,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        num_beams: int = 1,
    ):
        """Greedy / sampled text continuation -> (window logits [n, W],
        text ids [n]).  The prompt keeps its trailing separator: the first
        token is generated from the SEP position, as the reference does."""
        _refuse_beams(num_beams)
        ts = self.cfg.token_space
        tokens, logits = self.generate(
            example, max_new_tokens=max_length, start=ts.start("text"), end=ts.end("text"),
            deterministic=deterministic, generator=generator,
            temperature=temperature, top_k=top_k, top_p=top_p)
        return logits, tokens - ts.start("text")

    def predict_response(
        self,
        image: np.ndarray,
        prompt_tokens: Sequence[int] = (),
        max_length: int = 128,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        num_beams: int = 1,
    ):
        """Text response to an image ([1, H, W, 3], 0..255): a caption when
        `prompt_tokens` is empty, an answer when it holds a question's ids.
        The trailing SEP is dropped (it is causally invisible to the read
        position) and generated tokens continue the text's inner positions.
        -> (window logits [n, W], text ids [n])."""
        _refuse_beams(num_beams)
        ts = self.cfg.token_space
        tokens, logits = self.generate(
            {"images": np.asarray(image), "text": list(prompt_tokens)},
            max_new_tokens=max_length, start=ts.start("text"), end=ts.end("text"),
            deterministic=deterministic, drop_trailing=1, generator=generator,
            inner_pos_continuation=True, temperature=temperature, top_k=top_k, top_p=top_p)
        return logits, tokens - ts.start("text")

    def predict_caption(self, image, max_length: int = 128, **kw):
        return self.predict_response(image, (), max_length, **kw)

    def predict_answer(self, image, question_tokens, max_length: int = 16, **kw):
        return self.predict_response(image, question_tokens, max_length, **kw)

    def predict_control(self, example: Dict, **kw):
        """`predict_control_batch` for one example (the re-pack path of
        control evaluation): an int for Discrete, an int array for
        MultiDiscrete, a float array for Box."""
        return self.predict_control_batch([example], **kw)[0]

    def rollout_session(self, **kw) -> "RolloutSession":
        return RolloutSession(self, **kw)

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


class RolloutSession:
    """Ring KV cache kept across the env steps of control rollouts (the
    JAX package's RolloutSession, the "rollout cache").

    `start` prefills the cache with whole-timestep prompts (or starts empty);
    each `step` ring-extends it with the new timestep's [obs | sep] tokens,
    evicting the oldest timestep slot, then decodes the action tokens, each
    written into the cache (so the slot leaves the step complete).  The ring
    holds context_timesteps whole timesteps, so the attended key set is the
    re-pack path's trimmed window; cached tokens keep the hidden states
    they were computed with (TransformerXL-style memory).  Until the first
    eviction the actions equal the re-pack path's.
    """

    def __init__(
        self,
        generator: Generator,
        *,
        obs_str: Optional[str],
        action_str: str,
        obs_tokens: int,
        action_tokens: int,
        action_kind: str,
        num_actions: Optional[int] = None,
        action_nvec: Optional[Sequence[int]] = None,
        context_timesteps: int,
        patches_per_timestep: int = 0,
    ):
        self.g = generator
        self.cfg = generator.cfg
        self.obs_str = obs_str
        self.action_str = action_str
        self.obs_tokens = obs_tokens
        self.action_tokens = action_tokens
        self.action_kind = action_kind
        self.action_nvec = None if action_nvec is None else [int(n) for n in action_nvec]
        self.patches_per_timestep = patches_per_timestep
        self.tpt = obs_tokens + 1 + action_tokens
        self.L = context_timesteps * self.tpt
        if self.L > self.cfg.context_len:
            raise ValueError(f"ring buffer {self.L} exceeds the cache length "
                             f"{self.cfg.context_len}")
        ts = self.cfg.token_space
        self.sel_start = ts.start(action_kind)
        self.sel_end = ts.end(action_kind)
        if action_kind == "discrete":
            if self.action_nvec is not None:
                if len(self.action_nvec) != action_tokens:
                    raise ValueError("action_nvec needs one range per action token")
                self.sel_end = self.sel_start + max(self.action_nvec) - 1
            else:
                if action_tokens != 1 or num_actions is None:
                    raise ValueError(
                        "plain discrete actions need action_tokens=1 and num_actions")
                self.sel_end = self.sel_start + num_actions - 1
        self._act_dtype = np.float32 if action_kind == "continuous" else np.int32
        self.caches = None
        self.slot_start = None

    @torch.inference_mode()
    def start(self, prompts: Sequence[Optional[Dict]]) -> None:
        """Begin episodes: prefill the cache with full-timestep prompts (real
        actions included), or start empty for promptless evaluation.  All
        rows must be prompted or all promptless."""
        g, model = self.g, self.g.model
        B, S, D = len(prompts), self.cfg.context_len, self.cfg.embed_dim
        if all(p is None for p in prompts):
            emb = torch.zeros(B, S, D, dtype=self.cfg.activation_dtype, device=g.device)
            lengths = np.zeros(B, np.int64)
        elif any(p is None for p in prompts):
            raise ValueError("mixed prompted / promptless rows are not supported")
        else:
            arrays = g.packer.pack_batch(list(prompts), pad_side="right")
            lengths = arrays.pop("lengths")
            if (lengths % self.tpt).any():
                raise ValueError("prompts must be whole timesteps")
            emb = model.embed_batch(to_device_batch(arrays, g.device))
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(g.device)
        last = torch.zeros(B, dtype=torch.long, device=g.device)  # logits unused
        _, self.caches = model.prefill(emb, mask, last=last)
        self.slot_start = (lengths % self.L).astype(np.int64)

    @torch.inference_mode()
    def step(
        self,
        observations: Sequence,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> List:
        """One env step for every row.  `observations` holds one
        single-timestep obs per row: an array with leading dim 1, or a dict
        of packer modality entries.  Returns decoded actions (ints for
        discrete, int arrays for MultiDiscrete, float arrays for
        continuous)."""
        if self.caches is None:
            raise RuntimeError("call start() first")
        g, model = self.g, self.g.model
        sampling = _resolve_sampling(g._default_sampling, temperature, top_k, top_p)
        B = len(observations)
        examples = [
            {**obs, self.action_str: np.zeros((1, self.action_tokens), self._act_dtype)}
            if isinstance(obs, dict)
            else {self.obs_str: obs,
                  self.action_str: np.zeros((1, self.action_tokens), self._act_dtype)}
            for obs in observations
        ]
        arrays = g.packer.pack_batch(examples, pad_side="right", seq_len=self.tpt,
                                     patch_budget=B * self.patches_per_timestep)
        arrays.pop("lengths")
        emb = model.embed_batch(to_device_batch(arrays, g.device))  # [B, tpt, D]
        k = self.obs_tokens + 1
        slot = torch.as_tensor(self.slot_start, device=g.device)
        last_logits = model.extend_step(emb[:, :k], slot, slot, self.tpt, self.L,
                                        self.caches)[:, -1]
        limits = (None if self.action_nvec is None
                  else torch.as_tensor(self.action_nvec, device=g.device))
        toks, _, _ = g._decode(
            last_logits, self.caches, slot + k, torch.zeros_like(slot),
            n_steps=self.action_tokens, start=self.sel_start, end=self.sel_end,
            deterministic=deterministic, rng=g._rng if generator is None else generator,
            with_pos=False, ring=False, limits=limits, return_logits=False,
            feed_last=True, sampling=sampling)
        self.slot_start = (self.slot_start + self.tpt) % self.L
        tokens = toks.cpu().numpy().astype(np.int64)
        ts = self.cfg.token_space
        if self.action_kind == "discrete":
            if self.action_nvec is not None:
                return [np.asarray(t - self.sel_start, np.int64) for t in tokens]
            return [int(t[0] - self.sel_start) for t in tokens]
        return [decode_np(t.astype(np.int32), n_bins=ts.continuous_tokens,
                          offset=ts.continuous_start) for t in tokens]
