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
  `predict_answer` on top of it, or on `generate_beam` with `num_beams > 1`
* `generate_beam`: batched beam search, the KV caches re-indexed by the
  surviving beams' parent rows every step; ties in the top `num_beams`
  break toward the lower (parent, token) index, as `jax.lax.top_k` breaks
  them
* `generate_spec` (prompt-lookup proposals) and `generate_spec_draft` (a
  draft model's proposals, e.g. `truncated_draft`): lossless speculative
  decoding, each round verifying a0 + K proposals in one append-mode
  `extend_step`; greedy output equals `generate`'s, sampled output keeps
  the target distribution (the point-mass rule, or min(1, p/q) with the
  (p - q)+ residual)
* `imagine`: world-model rollout of observation tokens, re-packing the
  history between steps
* the continuous-batching engine (`engine_init` / `engine_admit` /
  `engine_chunk` / `engine_spec_chunk`, driven by serving/continuous.py):
  a pool of cache rows decoding in lockstep with per-row greedy /
  temperature / top-p knobs; `engine_admit` prefills every prompt it is
  given in one call (the JAX package prefills one prompt a call)
* `RolloutSession` (the rollout cache of control evaluation): the KV cache
  lives across env steps; each step ring-extends it with the new timestep's
  [obs | sep] tokens (`NekoModel.extend_step`, evicting the oldest timestep
  slot) and decodes the action tokens through the decode kernel, every
  generated token written into the cache

The JAX package's device loops (`lax.scan`, `lax.while_loop`) are Python
loops here; a speculative round reads its accepted counts back to decide
whether another round runs.  Sampled paths draw from `torch.Generator`
streams, so their draws differ from jax.random's; their distributions do
not.  Every position a parked (finished) row writes is clamped into the
cache, where the JAX package's scatters drop out-of-range writes.

The Generator serves from the model it is given, cast in place to the
activation dtype: a caller that trains the weights hands it a copy
(`set_params` refreshes the copy from a state dict).  `weight_dtype='fp8'`
serves the large matmul weights as e4m3 with per-output-channel scales
(inference/quant.py), dequantized at each use; the model's
`kv_cache_dtype='int8'` keeps int8 caches, which every path that copies or
re-indexes cache rows (beams, the draft, the engine's slots) carries with
their scales.

Over a 'model' axis of ranks (a model built for one rank by
`convert.build_model(..., mesh=)`) every rank runs the same calls in
lockstep: each holds its heads' caches and gathers the whole logits, so
with the sampling streams seeded alike (`seed`) every rank picks the same
tokens.  serving/server.py keeps the ranks' calls in one order.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from neko_tpu_torch.data.batch import to_device_batch
from neko_tpu_torch.data.packing import SequencePacker
from neko_tpu_torch.inference import quant
from neko_tpu_torch.models.policy import NekoModel
from neko_tpu_torch.models.transformer import empty_cache
from neko_tpu_torch.tokenizers.continuous import decode_mu_law_np, decode_np
from neko_tpu_torch.utils import trace


def apply_logit_filters(window: torch.Tensor, *, temperature=1.0, top_k: int = 0,
                        top_p=1.0, use_top_p: Optional[bool] = None) -> torch.Tensor:
    """Serving-time logit warps on the last axis: temperature -> top-k ->
    top-p (nucleus).  Returns warped logits for SAMPLING only.

    `temperature` and `top_p` may be tensors that broadcast against the
    window (the engine's per-row knobs); `use_top_p` then says whether the
    nucleus sort runs (inferred from a float `top_p`).  top-p keeps the
    minimal descending-probability prefix whose cumulative mass reaches
    `top_p` (the most likely token is always kept); ties at the cut keep
    every tied logit."""
    if isinstance(temperature, torch.Tensor) or temperature != 1.0:
        window = window / temperature
    W = window.shape[-1]
    if top_k and top_k < W:
        kth = torch.topk(window, top_k, dim=-1).values[..., -1:]
        window = window.masked_fill(window < kth, -torch.inf)
    if use_top_p is None:
        use_top_p = top_p < 1.0
    if use_top_p:
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


def _categorical(logits: torch.Tensor, rng) -> torch.Tensor:
    """One draw per row of [N, W] logits (-inf = excluded)."""
    return torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=rng)[:, 0]


def _pick(window: torch.Tensor, deterministic: bool, rng, sampling) -> torch.Tensor:
    """Token index within `window` [N, W] per row: the first maximum, or a
    draw from the warped distribution."""
    if deterministic:
        return window.argmax(dim=-1)
    temperature, top_k, top_p = sampling
    warped = apply_logit_filters(window, temperature=temperature, top_k=top_k, top_p=top_p)
    return _categorical(warped, rng)


def _first_rejection(ok: torch.Tensor) -> torch.Tensor:
    """Per row of bool [N, K], the index of the first False (K if none):
    the accepted prefix length of a verify round."""
    zero = torch.zeros(ok.shape[0], 1, dtype=torch.int32, device=ok.device)
    return torch.cat([ok.int(), zero], dim=1).argmin(dim=1)


def _accept_prob(P: torch.Tensor, props: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """P(t) of each proposal t [N, K] under the warped target P [N, K, W]
    (0 for a proposal outside the window): the point-mass acceptance
    probability."""
    W = P.shape[-1]
    pt = P.gather(2, (props - start).clamp(0, W - 1)[..., None])[..., 0]
    return torch.where((props >= start) & (props <= end), pt, 0.0)


def _rejected(props: torch.Tensor, m: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Window-relative id of each row's first rejected proposal, or -1 when
    all were accepted or it lies outside the window (a point mass outside
    P's support leaves the residual (P - Q)+ = P)."""
    K = props.shape[1]
    rj = props[torch.arange(props.shape[0], device=props.device), m.clamp(max=K - 1)]
    return torch.where((m < K) & (rj >= start) & (rj <= end), rj - start, -1)


def _mask_rejected(warped: torch.Tensor, reject: torch.Tensor) -> torch.Tensor:
    """The residual of a point-mass rejection: the window-relative id in
    `reject` [N] (-1 = none) masked out of each row of `warped` [N, W]."""
    W = warped.shape[-1]
    oh = torch.nn.functional.one_hot(reject.clamp(0, W - 1), W).bool()
    return warped.masked_fill((reject >= 0)[:, None] & oh, -torch.inf)


def lookup_proposals(hist: torch.Tensor, pos: torch.Tensor, *, K: int,
                     ngram: int) -> torch.Tensor:
    """Prompt-lookup proposals, batched: per row, the K tokens that followed
    the most recent occurrence of the ngram-length suffix ending at `pos` in
    `hist` [N, Hlen] (repeating recent context when there is none)
    -> [N, K]."""
    N, Hlen = hist.shape
    dev = hist.device
    rows = torch.arange(N, device=dev)
    idx = torch.arange(Hlen, device=dev)[None, :]
    ok = idx < (pos - ngram)[:, None]
    match = torch.ones(N, Hlen, dtype=torch.bool, device=dev)
    for j in range(ngram):
        tail = hist[rows, (pos - ngram + j).clamp(0, Hlen - 1)]
        match &= torch.roll(hist, -j, dims=1) == tail[:, None]
    i_star = torch.where(ok & match, idx, -1).max(dim=1).values
    base = torch.where(i_star >= 0, i_star + ngram, pos - 1)
    cols = base.clamp(0, Hlen - K)[:, None] + torch.arange(K, device=dev)
    return hist[rows[:, None], cols]


def _truncated_model(model: NekoModel, n_layers: int) -> NekoModel:
    """A NekoModel over the first n_layers blocks of `model`, sharing its
    modules (embeddings, blocks, final LN, head): no weight is copied."""
    cfg = dataclasses.replace(model.cfg, layers=n_layers)
    tf = copy.copy(model.transformer)
    tf._modules = dict(tf._modules)
    tf.h = nn.ModuleList(list(model.transformer.h)[:n_layers])
    tf.cfg = cfg
    out = copy.copy(model)
    out._modules = dict(out._modules)
    out.transformer = tf
    out.cfg = cfg
    return out


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
        weight_dtype: Optional[str] = None,
    ):
        """`model` holds the weights and sits on the device generation runs
        on.  The serve cast is applied to it in place: every floating weight
        is cast to the config's activation dtype, as the JAX Generator's
        `_maybe_cast` serves from an activation-dtype copy (a no-op for fp32
        configs).  `temperature`/`top_k`/`top_p` are the default sampling
        knobs; per-call arguments override them.

        `weight_dtype`: None / 'bf16' serve the cast weights; 'fp8' (alias
        'fp8_e4m3') quantizes the eligible matmul weights after the cast, in
        place (`quant.quantize_state_dict`, then `convert.assign_state`),
        unless the model already holds them quantized: a model over a
        'model' axis must, since its canonical weights are quantized before
        they are split (`quant.quantize_state_dict`, then
        `convert.build_model`)."""
        self.model = model.eval()
        self.cfg = model.cfg
        _check_sampling_args(temperature, top_k, top_p)
        self._default_sampling = (temperature, top_k, top_p)
        self.packer = packer or SequencePacker(model.cfg)
        self._wq = quant.wants_fp8(weight_dtype)
        quant.serve_cast(model, self.cfg.activation_dtype)
        if self._wq and not quant.is_quantized(model):
            if model.tp.on:
                raise ValueError("fp8 weights over a 'model' axis: quantize the canonical "
                                 "weights, then split them (quant.quantize_state_dict, then "
                                 "convert.build_model); a row-parallel shard quantized alone "
                                 "gets other scales")
            from neko_tpu_torch.convert import assign_state

            assign_state(model, quant.quantize_state_dict(model.state_dict()))
        self.device = next(model.parameters()).device
        # persistent sampling stream: calls without a generator still get
        # fresh draws each time
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)

    @torch.no_grad()
    def set_params(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Copy weights (any dtype, any device) into the served model with
        the serve cast (and the fp8 quantization after it, one process):
        the caller's tensors are read, never changed."""
        if self._wq:
            if self.model.tp.on:
                raise ValueError("set_params of fp8 weights over a 'model' axis: build the "
                                 "rank's model from the quantized canonical weights")
            state_dict = quant.quantize_state_dict(
                quant.serve_cast_state_dict(state_dict, self.cfg.activation_dtype))
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
        inner_pos_start: Optional[int] = None,
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
        tokens (predict_text / predict_control); `inner_pos_start` restarts
        those positions there (imagine).  `step_limits` (one width
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
                    inner_pos_start=inner_pos_start,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    step_limits=step_limits)
                return toks[0], windows[0]
            next_pos = int(arrays["inner_pos"][0, :max(L, 1)].max()) + 1
            emb = model.embed_batch(to_device_batch(arrays, dev))
        else:
            emb, L = prompt_emb.to(dev), int(prompt_len)
        if inner_pos_start is not None:
            next_pos, inner_pos_continuation = inner_pos_start, True
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
        inner_pos_start: Optional[int] = None,
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
        window, int [N, T]) when given.  All rows generate max_new_tokens.
        `inner_pos_start` restarts the generated tokens' inner positions
        there (imagine: generated observation token i embeds with the inner
        position i it has in a packed training stream)."""
        temperature, top_k, top_p = _resolve_sampling(
            self._default_sampling, temperature, top_k, top_p
        )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if step_limits is not None and len(step_limits) != max_new_tokens:
            raise ValueError("step_limits needs one entry per generated token")
        dev = self.device
        arrays, lengths = self._pack(examples, drop_trailing)
        next_pos = arrays["inner_pos"].max(axis=1) + 1  # [N]
        if inner_pos_start is not None:
            next_pos = np.full_like(next_pos, inner_pos_start)
            inner_pos_continuation = True
        ring = int(lengths.max()) + max_new_tokens > self.cfg.context_len
        rng = self._rng if generator is None else generator
        pos, last_logits, caches = self._prefill(self.model, arrays, lengths)  # [N, V]
        next_pos = torch.as_tensor(next_pos, dtype=torch.long, device=dev)

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

    # ------------------------------------------------------------- helpers
    def _pack(self, examples: Sequence[Dict], drop_trailing: int = 0):
        """Right-padded packed arrays (without "lengths") and the prompt
        lengths less `drop_trailing`."""
        arrays = self.packer.pack_batch(examples, pad_side="right")
        return arrays, arrays.pop("lengths") - drop_trailing

    def _prefill(self, model, arrays, lengths):
        """Prefill `model` on packed arrays -> (pos long [N] on the device,
        last-position logits [N, V], caches)."""
        dev, S = self.device, self.cfg.context_len
        emb = model.embed_batch(to_device_batch(arrays, dev))
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
        pos = torch.as_tensor(lengths, dtype=torch.long, device=dev)
        last, caches = model.prefill(emb, mask, last=pos - 1)
        return pos, last, caches

    def _embed_step(self, tok, next_pos, with_pos: bool):
        if with_pos:
            return self.model.embed_tokens_with_pos(tok[:, None], next_pos[:, None])
        return self.model.embed_tokens(tok[:, None])

    # --------------------------------------------------------------- beams
    @torch.inference_mode()
    def generate_beam(
        self,
        examples: Sequence[Dict],
        *,
        max_new_tokens: int,
        start: int,
        end: int,
        num_beams: int = 4,
        drop_trailing: int = 0,
        inner_pos_continuation: bool = False,
        return_logits: bool = False,
    ):
        """Batched beam search restricted to [start, end].  Every row's KV
        cache rides the beam: each step re-indexes every layer's keys,
        values and mask (leading axis N * num_beams rows) by the surviving
        beams' parent rows, then runs one decode step for all of them.

        Returns (tokens int64 [N, num_beams, T], scores fp32 [N, num_beams]
        cumulative log-probs, descending: beam 0 is the best), plus the raw
        window logits along each surviving beam [N, num_beams, T, W] with
        return_logits.  Sequences are fixed-length (no EOS), so scores need
        no length normalization.  Context overflow is refused."""
        W = end - start + 1
        if not 1 <= num_beams <= W:
            raise ValueError(f"num_beams={num_beams} must lie in [1, {W}] (the window): step 0 "
                             "has one live beam, so wider beams would be dead duplicates")
        dev, B, N = self.device, num_beams, len(examples)
        arrays, lengths = self._pack(examples, drop_trailing)
        if int(lengths.max()) + max_new_tokens > self.cfg.context_len:
            raise ValueError("beam search does not support context overflow")
        next_pos = arrays["inner_pos"].max(axis=1) + 1
        pos, last, caches = self._prefill(self.model, arrays, lengths)

        def rep(t):  # rows [n0b0, n0b1, ..., n1b0, ...]
            return t.repeat_interleave(B, dim=0)

        caches = [{k: rep(v) for k, v in c.items()} for c in caches]
        last, pos = rep(last), rep(pos)
        next_pos = rep(torch.as_tensor(next_pos, dtype=torch.long, device=dev))
        # only beam 0 is live at step 0 (every beam holds the same prefill)
        cum = torch.full((N, B), -1e30, dtype=torch.float32, device=dev)
        cum[:, 0] = 0.0
        tokbuf = torch.zeros(N * B, max_new_tokens, dtype=torch.long, device=dev)
        logbuf = (torch.zeros(N * B, max_new_tokens, W, dtype=torch.float32, device=dev)
                  if return_logits else None)
        base = (torch.arange(N, device=dev) * B)[:, None]
        for i in range(max_new_tokens):
            window = last[:, start:end + 1]
            logp = torch.log_softmax(window, dim=-1)
            total = (cum.reshape(N * B, 1) + logp).reshape(N, B * W)
            # the top B with ties toward the lower index, as lax.top_k
            cum, idx = (t[:, :B] for t in torch.sort(total, dim=1, descending=True,
                                                    stable=True))
            rowp = (base + idx // W).reshape(-1)
            tok = (idx % W + start).reshape(-1)
            tokbuf = tokbuf[rowp]
            tokbuf[:, i] = tok
            if return_logits:
                logbuf = logbuf[rowp]
                logbuf[:, i] = window[rowp]
            if i == max_new_tokens - 1:
                break  # the last token's decode step would feed nothing
            for c in caches:
                for k in c:
                    c[k] = c[k][rowp]
            last = self.model.decode_step(self._embed_step(tok, next_pos, inner_pos_continuation),
                                          pos, caches)[:, 0]
            pos, next_pos = pos + 1, next_pos + 1
        out = (tokbuf.reshape(N, B, -1).cpu().numpy(), cum.float().cpu().numpy())
        if return_logits:
            out += (logbuf.reshape(N, B, max_new_tokens, W).cpu().numpy(),)
        return out

    # --------------------------------------------------------- speculation
    def _spec_pack(self, example, K: int, max_new_tokens: int):
        """-> (one example given, examples, packed arrays, lengths) for a
        speculative call, refusing context overflow."""
        single = isinstance(example, dict)
        examples = [example] if single else list(example)
        if K < 1:
            raise ValueError(f"speculate_k must be >= 1, got {K}")
        arrays, lengths = self._pack(examples)
        if int(lengths.max()) + max_new_tokens + K + 1 > self.cfg.context_len:
            raise ValueError("spec decode does not support context overflow")
        return single, examples, arrays, lengths

    @torch.inference_mode()
    def generate_spec(
        self,
        example,
        *,
        max_new_tokens: int,
        start: int,
        end: int,
        speculate_k: int = 4,
        lookup_ngram: int = 2,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ):
        """LOSSLESS speculative decoding with prompt-lookup proposals: each
        round verifies a0 + speculate_k candidates in one append-mode
        extend_step; the proposals are the tokens that followed the most
        recent earlier occurrence of the trailing `lookup_ngram` tokens.

        deterministic=True: every emitted token is verified equal to greedy
        decoding's, so the output equals generate()'s.  deterministic=False:
        the point-mass rejection rule (accept proposal t with probability
        P(t) under the warped target; on rejection draw from P with t
        masked out), which keeps the target distribution exactly.  Only the
        number of rounds changes.

        Text prompts only (the lookup reads a token history).  One example
        dict -> (token ids [max_new_tokens], rounds); a sequence of dicts ->
        (token ids [N, max_new_tokens], rounds): rows run in lockstep rounds
        with their own positions and acceptance, a finished row parks until
        the slowest one is done, and `rounds` counts rounds for all."""
        K = int(speculate_k)
        if lookup_ngram < 1:
            raise ValueError(f"lookup_ngram must be >= 1, got {lookup_ngram}")
        single, examples, arrays, lengths = self._spec_pack(example, K, max_new_tokens)
        if any("images" in ex for ex in examples):
            raise ValueError("spec decode needs a token history (no images)")
        sampling = _resolve_sampling(self._default_sampling, temperature, top_k, top_p)
        S = self.cfg.context_len
        pos, last, caches = self._prefill(self.model, arrays, lengths)
        hist = np.zeros((len(examples), S + K + 1), np.int64)
        for i, L in enumerate(lengths):
            hist[i, :L] = arrays["tokens"][i][:L]
        toks, rounds = self._spec_decode(
            caches, last, torch.as_tensor(hist, device=self.device), pos,
            self._rng if generator is None else generator, n_steps=max_new_tokens,
            start=start, end=end, K=K, ngram=int(lookup_ngram),
            deterministic=deterministic, sampling=sampling)
        return (toks[0], rounds) if single else (toks, rounds)

    def _spec_decode(self, caches, last_logits, hist, pos, rng, *, n_steps, start, end, K,
                     ngram, deterministic, sampling):
        """The rounds of generate_spec.  Cache discipline (append-mode
        extend): round r writes the chunk at [pos, pos + K]; the next
        round's writes at pos' <= pos + K + 1 cover the rejected tail, and
        query i attends columns <= pos + i, so a stale entry is never
        attended.  A finished row parks: its position and output stop
        advancing while it re-verifies its last chunk (written at a
        position clamped into the cache)."""
        S, dev = self.cfg.context_len, self.device
        N = pos.shape[0]
        rows = torch.arange(N, device=dev)
        kcol = torch.arange(K + 1, device=dev)[None, :]
        temperature, top_k, top_p = sampling

        def warp(w):
            return apply_logit_filters(w, temperature=temperature, top_k=top_k, top_p=top_p)

        out = torch.zeros(N, n_steps + K + 1, dtype=torch.long, device=dev)
        emitted = torch.zeros(N, dtype=torch.long, device=dev)
        reject = torch.full((N,), -1, dtype=torch.long, device=dev)
        rounds = 0
        while bool((emitted < n_steps).any()):
            done = emitted >= n_steps
            win0 = last_logits[:, start:end + 1]
            if deterministic:
                a0w = win0.argmax(dim=-1)
            else:  # the prior round's rejected proposal masked out
                a0w = _categorical(_mask_rejected(warp(win0), reject), rng)
            a0 = a0w + start
            hist[rows, pos] = a0
            props = lookup_proposals(hist, pos + 1, K=K, ngram=ngram)
            chunk = torch.cat([a0[:, None], props], dim=1)             # [N, K+1]
            logits = self.model.extend_step(self.model.embed_tokens(chunk),
                                            pos.clamp(max=S - K - 1), caches=caches)
            win = logits[:, :, start:end + 1]                          # [N, K+1, W]
            if deterministic:
                ok = props == win.argmax(dim=-1)[:, :K] + start
            else:  # accept t with probability P(t) under the warped target
                pt = _accept_prob(torch.softmax(warp(win[:, :K]), dim=-1), props, start, end)
                ok = torch.rand(N, K, device=dev, generator=rng) < pt
            m = _first_rejection(ok).long()
            reject = _rejected(props, m, start, end)
            off = emitted.clamp(max=n_steps)[:, None] + kcol
            out[rows[:, None], off] = chunk
            hist[rows[:, None], pos[:, None] + kcol] = chunk
            adv = torch.where(done, 0, m + 1)
            emitted, pos = emitted + adv, pos + adv
            last_logits = logits[rows, m]
            rounds += 1
        return out[:, :n_steps].cpu().numpy(), rounds

    def truncated_draft(self, n_layers: int) -> "Generator":
        """Self-speculative draft: the target's first n_layers blocks with
        its embeddings, final LN and head, sharing the target's modules (no
        weight is copied).  Pass it to generate_spec_draft or to
        NekoServer(draft_generator=...); acceptance depends on how
        predictive the early layers are, losslessness does not."""
        if not 1 <= n_layers < self.cfg.layers:
            raise ValueError(f"need 1 <= n_layers < {self.cfg.layers}, got {n_layers}")
        return Generator(_truncated_model(self.model, n_layers), self.packer,
                         weight_dtype="fp8" if self._wq else None)

    @torch.inference_mode()
    def generate_spec_draft(
        self,
        example,
        draft: "Generator",
        *,
        max_new_tokens: int,
        start: int,
        end: int,
        speculate_k: int = 4,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ):
        """LOSSLESS speculative decoding with a DRAFT MODEL (Leviathan /
        Chen): per round the draft proposes K tokens from its own KV cache
        and the target verifies a0 + K in one extend_step.  Sampled mode
        accepts proposal t_i with probability min(1, p_i(t_i) / q_i(t_i))
        and draws the next a0 from the normalized residual (p - q)+ after a
        rejection, which keeps the target distribution exactly; greedy
        output equals plain greedy decoding's.  Any prompt modality.
        `draft` must share the target's token space and context length.
        Returns as generate_spec."""
        dc, tc = draft.cfg, self.cfg
        if (dc.text_tokens, dc.continuous_tokens, dc.discrete_tokens) != (
                tc.text_tokens, tc.continuous_tokens, tc.discrete_tokens):
            raise ValueError("draft and target must share the token space")
        if dc.context_len != tc.context_len:
            raise ValueError("draft and target must share context_len (one packer feeds "
                             "both caches)")
        K = int(speculate_k)
        single, _, arrays, lengths = self._spec_pack(example, K, max_new_tokens)
        sampling = _resolve_sampling(self._default_sampling, temperature, top_k, top_p)
        pos, last, caches = self._prefill(self.model, arrays, lengths)
        _, _, caches_d = self._prefill(draft.model, arrays, lengths)
        toks, rounds = self._spec_draft(
            draft, caches, caches_d, last, pos, self._rng if generator is None else generator,
            n_steps=max_new_tokens, start=start, end=end, K=K,
            deterministic=deterministic, sampling=sampling)
        return (toks[0], rounds) if single else (toks, rounds)

    def _spec_draft(self, draft, caches, caches_d, last_logits, pos, rng, *, n_steps, start,
                    end, K, deterministic, sampling):
        """The rounds of generate_spec_draft.  The target's verify extend
        runs in append mode (see _spec_decode).  The draft ingests a0 with
        a ring extend that clears [pos, pos + K + 1) first (the stale
        proposals of the previous round), then proposes by decode steps,
        which read the cache mask the ring extend maintains."""
        S, dev = self.cfg.context_len, self.device
        N = pos.shape[0]
        rows = torch.arange(N, device=dev)
        kcol = torch.arange(K + 1, device=dev)[None, :]
        W = end - start + 1
        temperature, top_k, top_p = sampling
        dm = draft.model

        def warp(w):
            return apply_logit_filters(w, temperature=temperature, top_k=top_k, top_p=top_p)

        out = torch.zeros(N, n_steps + K + 1, dtype=torch.long, device=dev)
        emitted = torch.zeros(N, dtype=torch.long, device=dev)
        has_rej = torch.zeros(N, dtype=torch.bool, device=dev)
        q_rej = torch.zeros(N, W, dtype=torch.float32, device=dev)
        rounds = 0
        while bool((emitted < n_steps).any()):
            done = emitted >= n_steps
            wpos = pos.clamp(max=S - K - 1)  # a parked row's writes stay in the cache
            win0 = last_logits[:, start:end + 1]
            if deterministic:
                a0w = win0.argmax(dim=-1)
            else:
                p0 = torch.softmax(warp(win0), dim=-1)
                resid = torch.where(has_rej[:, None], (p0 - q_rej).clamp(min=0.0), p0)
                # a numerically empty residual (p ~= q everywhere) falls back to p0
                resid = torch.where(resid.sum(-1, keepdim=True) > 1e-9, resid, p0)
                a0w = torch.multinomial(resid, 1, generator=rng)[:, 0]
            a0 = a0w + start
            # ---- the draft: ingest a0 (clearing the stale tail), propose K
            dlog = dm.extend_step(dm.embed_tokens(a0[:, None]), wpos, wpos, K + 1, S,
                                  caches_d)
            qlast = dlog[:, -1]
            props, qdists, qsel = [], [], []
            for i in range(K):
                qw = warp(qlast[:, start:end + 1])
                qprob = torch.softmax(qw, dim=-1)
                tw = qw.argmax(dim=-1) if deterministic else _categorical(qw, rng)
                ti = tw + start
                props.append(ti)
                qdists.append(qprob)
                qsel.append(qprob[rows, tw])
                qlast = dm.decode_step(dm.embed_tokens(ti[:, None]), wpos + 1 + i,
                                       caches_d)[:, 0]
            props = torch.stack(props, dim=1)                          # [N, K]
            qd = torch.stack(qdists, dim=1)                            # [N, K, W]
            qs = torch.stack(qsel, dim=1)                              # [N, K]
            # ---- the target: verify the whole chunk in one extend
            chunk = torch.cat([a0[:, None], props], dim=1)
            logits = self.model.extend_step(self.model.embed_tokens(chunk), wpos,
                                            caches=caches)
            win = logits[:, :, start:end + 1]                          # [N, K+1, W]
            if deterministic:
                ok = props == win.argmax(dim=-1)[:, :K] + start
            else:
                P = torch.softmax(warp(win[:, :K]), dim=-1)
                pt = P.gather(2, (props - start)[..., None])[..., 0]
                ok = torch.rand(N, K, device=dev, generator=rng) * qs < pt  # u < p/q
            m = _first_rejection(ok).long()
            if not deterministic:
                has_rej = m < K
                q_rej = torch.where(has_rej[:, None], qd[rows, m.clamp(max=K - 1)], 0.0)
            off = emitted.clamp(max=n_steps)[:, None] + kcol
            out[rows[:, None], off] = chunk
            adv = torch.where(done, 0, m + 1)
            emitted, pos = emitted + adv, pos + adv
            last_logits = logits[rows, m]
            rounds += 1
        return out[:, :n_steps].cpu().numpy(), rounds

    # ------------------------------------------------------- world model
    def imagine(
        self,
        example: Dict,
        actions: np.ndarray,
        *,
        obs_kind: str = "discrete",
        obs_nvec: Optional[Sequence[int]] = None,
        context_timesteps: Optional[int] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> np.ndarray:
        """World-model rollout: the observations of K future timesteps given
        their actions, each prediction fed back as history.

        `example` is a control history {*_obs: [T, n], *_actions: [T, m]}
        of a model trained with --observation_loss; `actions` [K, m] the K
        future actions.  Each step generates the next timestep's n
        observation tokens (per-component ranges via `obs_nvec`) with inner
        positions restarting at 0, as packed observations embed, decodes
        them (continuous ones through the mu-law bins), appends (prediction,
        action) to the history and re-packs it.  -> predictions [K, n]."""
        ts = self.cfg.token_space
        actions = np.asarray(actions)
        if actions.ndim != 2:
            raise ValueError("actions must be [K, action_tokens]")
        obs_str = f"{obs_kind}_obs"
        if obs_str not in example:
            raise ValueError(f"history lacks {obs_str}")
        action_str = ("discrete_actions" if "discrete_actions" in example
                      else "continuous_actions")
        obs_hist = np.asarray(example[obs_str])
        act_hist = np.asarray(example[action_str])
        n = obs_hist.shape[1]
        start, end = ts.start(obs_kind), ts.end(obs_kind)
        limits = None
        if obs_kind == "discrete" and obs_nvec is not None:
            if len(obs_nvec) != n:
                raise ValueError("obs_nvec needs one range per observation token")
            end = start + int(max(obs_nvec)) - 1
            limits = [int(v) for v in obs_nvec]
        # history + the n generated tokens stay inside the context
        tpt = n + 1 + act_hist.shape[1]
        max_ts = (self.cfg.context_len - n) // tpt
        if max_ts < 1:
            raise ValueError(f"one timestep ({tpt} tokens) + {n} generated obs tokens "
                             f"exceed the context ({self.cfg.context_len})")
        if context_timesteps is not None:
            if context_timesteps < 1:
                raise ValueError("context_timesteps must be >= 1")
            max_ts = min(max_ts, context_timesteps)
        preds = []
        for k in range(actions.shape[0]):
            obs_hist, act_hist = obs_hist[-max_ts:], act_hist[-max_ts:]
            (toks,) = self.generate_batch(
                [{obs_str: obs_hist, action_str: act_hist}], max_new_tokens=n, start=start,
                end=end, deterministic=deterministic, generator=generator, inner_pos_start=0,
                return_logits=False, temperature=temperature, top_k=top_k, top_p=top_p,
                step_limits=limits)
            toks = toks[0]
            if obs_kind == "discrete":
                obs_next = np.asarray(toks - start, obs_hist.dtype)
            else:  # packed with mu-law companding: invert bin and companding
                obs_next = decode_mu_law_np(
                    np.asarray(toks, np.int32), mu=self.cfg.mu, M=self.cfg.M,
                    n_bins=ts.continuous_tokens, offset=ts.continuous_start,
                ).astype(obs_hist.dtype)
            preds.append(obs_next)
            obs_hist = np.concatenate([obs_hist, obs_next[None]], axis=0)
            act_hist = np.concatenate(
                [act_hist, actions[k][None].astype(act_hist.dtype)], axis=0)
        return np.stack(preds)

    # ------------------------------------------ continuous-batching engine
    @torch.inference_mode()
    def engine_init(self, slots: int, speculate_k: int = 0) -> Dict:
        """Engine state: `slots` cache rows, all free (an all-False cache
        mask), and last logits / positions per row.  speculate_k > 0 adds
        the per-row token history of engine_spec_chunk's prompt lookup and
        the pending sampled-rejection residual (-1 = none).  The scheduler
        is serving/continuous.py."""
        cfg, dev = self.cfg, self.device
        S = cfg.context_len
        heads = self.model.transformer.h[0].attn.heads  # this rank's, over 'model'
        caches = [empty_cache(cfg, slots, heads, dev) for _ in range(cfg.layers)]
        state = {"caches": caches,
                 "last": torch.zeros(slots, cfg.padded_vocab_size, device=dev),
                 "pos": torch.zeros(slots, dtype=torch.long, device=dev)}
        if speculate_k > 0:
            state["hist"] = torch.zeros(slots, S + speculate_k + 1, dtype=torch.long,
                                        device=dev)
            state["reject"] = torch.full((slots,), -1, dtype=torch.long, device=dev)
        return state

    @torch.inference_mode()
    def engine_admit(self, state: Dict, slot, example, drop_trailing: int = 0) -> Dict:
        """Prefill prompts and install them in engine slots while the other
        slots ride along untouched: one slot and one example dict, or a
        list of each, all prefilled in one call.  Updates `state` in place
        and returns it; `state["admit_prompt_tokens"]` holds this call's
        prompt tokens (each row is prefilled at the full context_len)."""
        slots = [slot] if isinstance(example, dict) else list(slot)
        examples = [example] if isinstance(example, dict) else list(example)
        with trace.span("admit.pack"):
            arrays, lengths = self._pack(examples, drop_trailing)
        with trace.span("admit.prefill"):
            pos, last, caches1 = self._prefill(self.model, arrays, lengths)
        with trace.span("admit.install"):
            b = torch.as_tensor(slots, dtype=torch.long, device=self.device)
            for c, c1 in zip(state["caches"], caches1):
                for k in c:
                    c[k][b] = c1[k]
            state["last"][b] = last
            state["pos"][b] = pos
            if "hist" in state:
                hrows = np.zeros((len(slots), state["hist"].shape[1]), np.int64)
                for i, L in enumerate(lengths):
                    hrows[i, :L] = arrays["tokens"][i][:L]
                state["hist"][b] = torch.as_tensor(hrows, device=self.device)
                state["reject"][b] = -1
        state["admit_prompt_tokens"] = int(lengths.sum())
        return state

    def _row_knobs(self, n, det, temp, top_p):
        det = np.ones(n, bool) if det is None else np.asarray(det, bool)
        temp = np.ones(n, np.float32) if temp is None else np.asarray(temp, np.float32)
        top_p = np.ones(n, np.float32) if top_p is None else np.asarray(top_p, np.float32)
        dev = self.device
        return (det, torch.as_tensor(det, device=dev), torch.as_tensor(temp, device=dev)[:, None],
                torch.as_tensor(top_p, device=dev)[:, None], bool((top_p < 1.0).any()))

    @torch.inference_mode()
    def engine_chunk(self, state: Dict, *, n_steps: int, start: int, end: int, det, temp,
                     top_p, generator: Optional[torch.Generator] = None):
        """Advance every slot by `n_steps` tokens -> (tokens int64 [N,
        n_steps] absolute ids, state, updated in place).  det / temp / top_p
        are per-row arrays (free slots: True / 1.0 / 1.0): greedy and
        sampled rows share every decode step.  Positions ring over the
        context per row (pos % context_len).  On a speculative state the
        tokens also enter the lookup history, and a pending sampled
        rejection is masked from the first draw, so plain chunks and spec
        rounds interleave without drift."""
        rng = self._rng if generator is None else generator
        det_np, det, temp, top_p, use_top_p = self._row_knobs(state["pos"].shape[0], det, temp,
                                                              top_p)
        S = self.cfg.context_len
        caches, last, pos = state["caches"], state["last"], state["pos"]
        hist, reject = state.get("hist"), state.get("reject")
        rows = torch.arange(pos.shape[0], device=self.device)
        toks = []
        for _ in range(n_steps):
            with trace.span("decode.step"):
                window = last[:, start:end + 1]
                tok = window.argmax(dim=-1)
                if not det_np.all():
                    warped = apply_logit_filters(window, temperature=temp, top_p=top_p,
                                                 use_top_p=use_top_p)
                    if reject is not None:  # a spec round's residual, on the first draw
                        warped = _mask_rejected(warped, reject)
                    tok = torch.where(det, tok, _categorical(warped, rng))
                if reject is not None:
                    reject = torch.full_like(reject, -1)
                tok = tok + start
                if hist is not None:
                    hist[rows, pos.clamp(max=hist.shape[1] - 1)] = tok
                last = self.model.decode_step(self.model.embed_tokens(tok[:, None]), pos % S,
                                              caches)[:, 0]
                pos = pos + 1
                toks.append(tok)
        state["last"], state["pos"] = last, pos
        if reject is not None:
            state["reject"] = reject
        with trace.span("chunk.fetch"):
            return torch.stack(toks, dim=1).cpu().numpy(), state

    @torch.inference_mode()
    def engine_spec_chunk(self, state: Dict, *, rounds: int, start: int, end: int, K: int,
                          ngram: int = 2, det=None, temp=None, top_p=None,
                          generator: Optional[torch.Generator] = None):
        """Advance every slot by `rounds` prompt-lookup verify rounds
        (engine_init(speculate_k=K)), greedy or sampled per row (default
        all greedy).  -> (chunks int64 [N, rounds, K+1] absolute ids, advs
        int64 [N, rounds] accepted counts, state, updated in place); row b's
        round-r tokens are chunks[b, r, :advs[b, r]].

        Each round is one append-mode extend verifying a0 + K proposals per
        row.  A row whose write window [pos, pos + K] would cross the
        context end PARKS (advances 0, keeps its state; its extend writes a
        clamped window of its own).  Sampled rows use the point-mass
        rejection rule, with the residual carried in `reject`.  Afterwards
        every layer's cache mask is refreshed to the accepted prefix
        [0, pos), which the append mode does not maintain and a later plain
        decode step reads."""
        rng = self._rng if generator is None else generator
        n = state["pos"].shape[0]
        det_np, det, temp, top_p, use_top_p = self._row_knobs(n, det, temp, top_p)
        S, dev = self.cfg.context_len, self.device
        caches, last, pos = state["caches"], state["last"], state["pos"]
        hist, reject = state["hist"], state["reject"]
        Hlen = hist.shape[1]
        rows = torch.arange(n, device=dev)
        kcol = torch.arange(K + 1, device=dev)[None, :]
        sampled = not det_np.all()

        def warp(w):
            extra = (1,) * (w.ndim - 2)  # the per-row knobs over any [N, ..., W]
            return apply_logit_filters(w, temperature=temp.reshape(n, *extra, 1),
                                       top_p=top_p.reshape(n, *extra, 1), use_top_p=use_top_p)

        chunks, advs = [], []
        for _ in range(rounds):
            with trace.span("spec.round"):
                parked = pos + K + 1 > S
                win0 = last[:, start:end + 1]
                a0 = win0.argmax(dim=-1)
                if sampled:
                    a0 = torch.where(det, a0, _categorical(_mask_rejected(warp(win0), reject), rng))
                a0 = a0 + start
                hist2 = hist.clone()
                hist2[rows, pos.clamp(max=Hlen - 1)] = a0
                props = lookup_proposals(hist2, pos + 1, K=K, ngram=ngram)
                chunk = torch.cat([a0[:, None], props], dim=1)             # [N, K+1]
                logits = self.model.extend_step(self.model.embed_tokens(chunk),
                                                pos.clamp(max=S - K - 1), caches=caches)
                win = logits[:, :, start:end + 1]                          # [N, K+1, W]
                ok = props == win.argmax(dim=-1)[:, :K] + start
                if sampled:  # the point-mass rule on the sampled rows
                    pt = _accept_prob(torch.softmax(warp(win[:, :K]), dim=-1), props, start, end)
                    ok = torch.where(det[:, None], ok,
                                     torch.rand(n, K, device=dev, generator=rng) < pt)
                m = _first_rejection(ok).long()
                new_reject = torch.where(det, -1, _rejected(props, m, start, end))
                adv = torch.where(parked, 0, m + 1)
                reject = torch.where(parked, reject, new_reject)
                hist2[rows[:, None], (pos[:, None] + kcol).clamp(max=Hlen - 1)] = chunk
                hist = torch.where(parked[:, None], hist, hist2)
                last = torch.where(parked[:, None], last, logits[rows, m])
                pos = pos + adv
                chunks.append(chunk)
                advs.append(adv)
        valid = torch.arange(S, device=dev)[None, :] < pos.clamp(max=S)[:, None]
        for c in caches:
            c["mask"].copy_(valid)
        state.update(last=last, pos=pos, hist=hist, reject=reject)
        with trace.span("chunk.fetch"):
            return (torch.stack(chunks, dim=1).cpu().numpy(),
                    torch.stack(advs, dim=1).cpu().numpy(), state)

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
        token is generated from the SEP position, as the reference does.
        num_beams > 1 runs beam search (deterministic; the sampling knobs
        are ignored) and returns the best beam."""
        ts = self.cfg.token_space
        if num_beams > 1:
            tokens, _, logits = self.generate_beam(
                [example], max_new_tokens=max_length, start=ts.start("text"),
                end=ts.end("text"), num_beams=num_beams, return_logits=True)
            return logits[0, 0], tokens[0, 0] - ts.start("text")
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
        -> (window logits [n, W], text ids [n]); num_beams > 1 runs beam
        search and returns the best beam."""
        ts = self.cfg.token_space
        example = {"images": np.asarray(image), "text": list(prompt_tokens)}
        if num_beams > 1:
            tokens, _, logits = self.generate_beam(
                [example], max_new_tokens=max_length, start=ts.start("text"),
                end=ts.end("text"), num_beams=num_beams, drop_trailing=1,
                inner_pos_continuation=True, return_logits=True)
            return logits[0, 0], tokens[0, 0] - ts.start("text")
        tokens, logits = self.generate(
            example,
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
        MultiDiscrete, a float array for Box.  An `action_nvec` component
        wider than the discrete token range raises, as the JAX package's
        predict_control asserts (its batch call does not check)."""
        nvec = kw.get("action_nvec")
        if kw.get("action_kind") == "discrete" and nvec is not None:
            width = self.cfg.token_space.discrete_tokens
            if max(nvec) > width:
                raise ValueError(f"action_nvec component {max(nvec)} exceeds the "
                                 f"{width}-token discrete range")
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
