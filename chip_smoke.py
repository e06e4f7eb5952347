#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (neko_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Device: exits non-zero unless CUDA is available; prints the card's name
   and power limit, builds the CUDA kernels from neko_tpu_torch/csrc/ with
   nvcc (sm_90a) and prints the build time.
2. Kernel vs plain: the whole-head attention kernel against its plain torch
   version at the flagship prefill shape (B=8, H=24, S=1024, hd=32, bf16)
   and at hd=64 / hd=128 in fp32, with both times from CUDA events.
3. Serve: a flagship-width model (768d/6L/24 heads, k=1024, full token
   space, bf16, random weights from a seed) behind NekoServer on 127.0.0.1,
   answering greedy and sampled text requests and continuous and image
   (discrete) action requests.  Every prefill of that run must have gone
   through the kernel (its launch counter).
4. Prefill check, on the greedy batch: each layer's kernel output against
   the plain version on the same served inputs, and the last-position
   logits against a prefill through the plain version on the card.  Planted
   faults in the plain version (controls) show what each check can see.
5. Training kernels vs plain, at the flagship train shape (B=16, H=24,
   S=1024, hd=32, bf16): q, k, v are head-packed strided views of one
   [B, S, 3D] tensor with left-padded bounds, a short row and an empty row.
   At dropout 0 and 0.1: out, dq, dk, dv against autograd through the plain
   version with the same materialized mask; the mask kernel against the
   plain Philox bit for bit, and its keep share; [B,H,S,hd] at hd 64 and 128
   in fp32.  Forward, backward and mask times, kernel and plain, from CUDA
   events in turns.
6. The flagship train step (neko_tpu_torch.bench's model and batch, random
   weights from the seed): warm-up and timed steps (step ms, tokens/s, MFU,
   peak memory); every loss finite; the launch counters show forward =
   backward = layers x steps.  One step with the kernels against the same
   step with the plain attention (same seeds, so the same masks; the plain
   attention gets its mask from the mask kernel): loss and every
   parameter's gradient, with planted faults in the plain forward and
   backward that the checks must see.  Then the loss must fall over 20 steps
   on one batch.
7. Blocked kernels vs plain (long context): the forward (o, m, l) and both
   backward routes (fused; dq + dkv) on head-packed strided views with
   left-padded, short and empty rows, bf16 at dropout 0 and 0.1 at the
   `long` and `long4k` shapes (B=8, S=2048 and B=4, S=4096; H=24, hd=32),
   fp32 at hd 64 and 128 and at S=3000; the plain versions get their mask
   from the mask kernel, which must equal the plain Philox bit for bit, and
   the plain backward gets the kernel forward's (m, l, delta), so that each
   backward kernel is held on its own inputs.  A fault planted in the plain
   backward (the key tile on each row's diagonal skipped) must fail every
   gradient check.  At S=1024 the blocked kernels agree with the whole-head
   ones at the same seed.  Times in turns (plain, kernel, kernel, plain),
   and SDPA's as a yardstick, at S=2048, 4096 and 8192 with the long
   configs' rows (8, 4, 2), and the two backward routes alone at S=16384
   (B=1): these set blocked_attention.FUSED_MAX.
8. The long train steps: `long` (768d/6L/24h, k=2048, 8 rows, dropout 0.1)
   timed, with launch counts = layers x steps; one step with the kernels
   against the same step with the plain blocked attention, with planted
   faults the checks must see; the loss falls over 20 steps on one batch;
   one timed `long4k` step and one step at k=8192 (the same width, 2 rows;
   not a root bench configuration).

Prints a JSON line of the kernels that only the checks launch
({"check_kernels": ...}), then one JSON line of the kernels the main path
runs ({"kernels": ...}; launches counted in the serving and train runs
alone, each with its bound from this run's shapes), then, as the last line,
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 0
FLAGSHIP = dict(embed_dim=768, layers=6, heads=24, context_len=1024,
                max_patches=936, dtype="bfloat16")
# kernel vs plain, on valid rows: |kernel - plain| <= atol + rtol * |plain|
#   bf16: atol 1e-2 plus rtol 2^-7 (one bf16 ulp, relative).  Both outputs
#   are rounded to bf16 (8 significant bits), and the kernel keeps the
#   probabilities in fp32 where the plain version rounds them to bf16 before
#   the value product (as the TPU kernel does); outputs reach |x| ~ 4 on
#   rows with few keys, where one bf16 ulp is 2^-6 = 1.56e-2 > 1e-2.
#   fp32: atol 1e-5, summation order only.
KERNEL_TOL = {"bfloat16": (1e-2, 2.0 ** -7), "float32": (1e-5, 0.0)}
# prefill logits at the last prompt position, kernel vs plain attention: 6
# bf16 layers deep, every activation rounded to bf16, on logits of std ~0.55
# at this init.  On an H100 the sound run read 2.54e-2 and the faintest
# planted fault ("diagonal excluded") 8.69e-2; the limit lies between.
LOGIT_TOL = 5e-2
# planted faults in the plain attention (controls).  Each layer's check must
# see every one; the logits check those in LOGIT_FAULTS.  "key window
# ignored" cannot move the logits of right-padded prompts: the window only
# differs from the causal mask on rows past the prompt.
FAULTS = ("causal mask dropped", "diagonal excluded", "key window ignored",
          "scale 1/hd")
LOGIT_FAULTS = ("causal mask dropped", "diagonal excluded", "scale 1/hd")
# training (phases 5 and 6)
TRAIN = dict(B=16, H=24, S=1024, hd=32)
RATE = 0.1
# gradients, kernel vs autograd through the plain version: sums of up to S
# products of rounded factors, rounded to bf16 once (the plain version also
# rounds p to bf16 before dv): 3e-2 absolute plus two bf16 ulps relative
# (gradients reach |x| ~ 8); fp32: summation order over S keys.
GRAD_TOL = {"bfloat16": (3e-2, 2.0 ** -6), "float32": (5e-5, 1e-4)}
# one train step, kernels vs plain attention: largest relative L2 error of a
# parameter's gradient, and the loss difference.  On an H100 the sound run
# read 9.86e-3 and 6.68e-6, the faintest planted backward fault ("keep mask
# not applied in the backward") 0.189, the faintest forward fault ("keep
# mask not applied in the forward") a loss difference of 4.29e-5; each limit
# lies between (the loss one near their geometric mean).  At random init
# the attention is near uniform, so forward faults move the loss little.
STEP_GRAD_TOL = 5e-2
STEP_LOSS_TOL = 1.7e-5
STEP_FAULTS = ("keep mask not applied in the backward", "delta taken as 0",
               "dk without sm_scale")
STEP_LOSS_FAULTS = ("keep mask not applied in the forward", "scale 1/hd in the forward",
                    "causal mask dropped in the forward")
# blocked kernels (phases 7 and 8): bf16 check shapes (B, H, S, hd), the
# `long` and `long4k` rows; fp32 shapes at other head dims and a ragged S
BLOCKED_BF16 = ((8, 24, 2048, 32), (4, 24, 4096, 32))
BLOCKED_FP32 = ((4, 12, 2048, 64), (2, 6, 2048, 128), (3, 8, 3000, 32))
# timed shapes: the rows of long, long4k and LONG8K (16,384 tokens each);
# beyond them the two backward routes alone, at 16,384 tokens too
BLOCKED_TIMED = ((8, 24, 2048, 32), (4, 24, 4096, 32), (2, 24, 8192, 32))
BLOCKED_ROUTES_ONLY = ((1, 24, 16384, 32),)
# blocked gradients, kernel vs the plain backward in fp32 on the same bf16
# inputs and the same (m, l, delta): the kernels compute in fp32 and round
# once, so the gap is half a bf16 ulp (at most 2^-8 relative) plus fp32
# summation order (the fused dq's atomics included); rtol is one ulp at
# worst, atol covers the fp32 order on values that cancel to ~0.  fp32 as
# GRAD_TOL.
BLOCKED_GRAD_TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float32": GRAD_TOL["float32"]}
# planted in the plain blocked backward of phase 7; every gradient check
# must fail against it
BLOCKED_FAULT = "diagonal key tile skipped in the backward"
# row stats, kernel vs plain on valid rows (atol, rtol): m is a max of fp32
# dot products (summation order only); l sums up to S terms of order 1,
# added in tiles of 32 by the kernel and pairwise by torch
STAT_TOL = {"m": (1e-5, 1e-5), "l": (1e-5, 1e-4)}
# one `long` step, kernels vs plain blocked attention: largest relative L2
# error of a parameter's gradient, and the loss difference.  On an H100 the
# sound run read 9.36e-3 and 1.22e-4 (the loss is a mean over ~7,000 targets
# of bf16-noisy logits); the faintest planted fault in the gradients was
# "running-max rescale alpha dropped" at 6.58e-2 (at random init the
# running max barely moves between key tiles, so its loss moved only
# 2.19e-5, under the sound reading), the only loss fault "key tiles above
# the diagonal included" at 4.48e-3.  Each limit lies near the geometric
# mean of the sound reading and the faintest fault.
LONG_STEP_GRAD_TOL = 2.5e-2
LONG_STEP_LOSS_TOL = 7e-4
LONG_STEP_FAULTS = ("running-max rescale alpha dropped", "delta taken as 0",
                    "keep mask not applied in the backward",
                    "key tiles above the diagonal included")
LONG_STEP_LOSS_FAULTS = ("key tiles above the diagonal included",)
# the k = 8192 step of phase 8: the `long` width at 2 rows, 16,384 tokens a
# step as `long` and `long4k`; the root bench has no k = 8192 configuration
LONG8K = dict(embed_dim=768, layers=6, heads=24, batch_per_chip=2, context_len=8192)
# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12


def _require(ok, what) -> None:
    if not ok:
        raise AssertionError(what)


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(min(3, iters)):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _pairs(start, end, S: int, H: int) -> int:
    """(query row, key) pairs the causal mask and the key windows leave
    visible, over every batch row and head: the work these inputs need."""
    import torch

    rows = torch.arange(S, device=start.device)[None, :]
    seen = torch.minimum(end.long()[:, None], rows + 1) - start.long()[:, None]
    return int(seen.clamp(min=0).sum().item()) * H


def _bound(flops: float, nbytes: float):
    """-> (least ms the card could take, "operations" or "bytes"): the larger
    of the FLOPs over the bf16 tensor-core peak and the bytes (each input
    read once, each output written once) over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _attention_bounds(pairs, B, H, S, hd, elt):
    """{kernel: (bound ms, bound_by)} from the visible pairs: per pair each
    product is 2*hd FLOPs (forward: s, pv; fused backward and the whole-head
    backward: s, dp, dq, dk, dv; dq: s, dp, dq; dkv: s, dp, dk, dv).  Bytes:
    the [B, S, H*hd] operands in `elt` bytes, fp32 [B, H, S] row stats."""
    act, row = B * S * H * hd * elt, B * H * S * 4
    return {
        "fwd": _bound(4 * hd * pairs, 4 * act + 2 * row),          # q k v o, m l
        "whole_fwd": _bound(4 * hd * pairs, 4 * act + row),        # q k v o, lse
        "whole_bwd": _bound(10 * hd * pairs, 8 * act + row),       # q k v o do dq dk dv, lse
        "fused": _bound(10 * hd * pairs, 7 * act + 3 * row),       # q k v do dq dk dv, m l delta
        "dq": _bound(6 * hd * pairs, 5 * act + 3 * row),
        "dkv": _bound(8 * hd * pairs, 6 * act + 3 * row),
    }


def _sdpa_ms(q4, k4, v4, do4, rate, iters):
    """(forward ms, backward ms) of torch's scaled_dot_product_attention,
    causal with dropout, on contiguous copies: the library yardstick (the
    port never calls it)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.detach().contiguous().requires_grad_() for t in (q4, k4, v4))
    do = do4.contiguous()

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, dropout_p=rate, is_causal=True)

    out = fwd()
    return (_time_ms(fwd, iters),
            _time_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True), iters))


def _against_plain(out, ref, start, end):
    """-> (max abs error, largest excess over the tolerance) on the rows
    that see a key (row >= start, start < end); the outputs are [B,H,S,hd]."""
    import torch

    rows = torch.arange(out.shape[2], device=out.device)[None, :]
    valid = ((rows >= start[:, None]) & (start < end)[:, None])[:, None, :, None]
    atol, rtol = KERNEL_TOL[str(ref.dtype).removeprefix("torch.")]
    diff = (out.float() - ref.float()).abs()
    err = diff.masked_fill(~valid, 0).max().item()
    excess = (diff - atol - rtol * ref.float().abs()).masked_fill(~valid, -1).max().item()
    return err, excess


def kernel_vs_plain(B, H, S, hd, dtype_name, starts, ends, timed):
    """-> (max abs error on valid rows, kernel ms, plain ms)."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(B, H, S, hd, device=dev, generator=g).to(dtype)
               for _ in range(3))
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    end = torch.tensor(ends, dtype=torch.int32, device=dev)
    out = whk.whole_head_attention(q, k, v, start, end)
    ref = whk.whole_head_attention_reference(q, k, v, start, end)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"kernel output not finite at {B}x{H}x{S}x{hd} {dtype_name}")
    err, excess = _against_plain(out, ref, start, end)
    atol, rtol = KERNEL_TOL[dtype_name]
    # which is closer to the same math on the fp32 upcast of the inputs
    exact = whk.whole_head_attention_reference(q.float(), k.float(), v.float(), start, end)
    e_k = _against_plain(out, exact, start, end)[0]
    e_p = _against_plain(ref, exact, start, end)[0]
    print(f"kernel vs plain B={B} H={H} S={S} hd={hd} {dtype_name}: "
          f"max abs err {err:.3e} (tolerance {atol:g} + {rtol:g}*|plain|); "
          f"vs fp32-input math: kernel {e_k:.3e}, plain {e_p:.3e}")
    if not excess <= 0:
        raise AssertionError(f"kernel disagrees with the plain version: {err}")
    ms = plain_ms = None
    if timed:  # in turns: plain, kernel, kernel, plain
        run_k = lambda: whk.whole_head_attention(q, k, v, start, end)  # noqa: E731
        run_p = lambda: whk.whole_head_attention_reference(q, k, v, start, end)  # noqa: E731
        p1, k1, k2, p2 = _time_ms(run_p), _time_ms(run_k), _time_ms(run_k), _time_ms(run_p)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        lib = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        bound = _bound(4 * hd * _pairs(start, end, S, H), 4 * q.numel() * q.element_size())
        print(f"  kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, SDPA (causal "
              f"over full rows) {lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return err, ms, plain_ms


def _post(url: str, payload: dict):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
        status = r.status
    return status, body, time.perf_counter() - t0


def serve(card: str):
    """Phase 3.  Returns (kernel launches in the serving run, the generator,
    the greedy prompts as examples)."""
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.serving.server import NekoServer

    cfg = ModelConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    gen = Generator(build_model(cfg, init_state_dict(cfg, SEED), "cuda"), seed=SEED)
    print(f"flagship model {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h k={cfg.context_len} "
          f"vocab {cfg.vocab_size} {cfg.dtype} built in {time.perf_counter() - t0:.1f} s")
    ts = cfg.token_space
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, ts.text_tokens, 512).tolist() for _ in range(4)]
    wants = [8, 16, 32, 32]
    frames = rng.integers(0, 256, (4, 96, 96, 3)).tolist()
    obs = rng.standard_normal((8, 17)).tolist()

    whk.whole_head_attention.launches = 0
    with NekoServer(gen, port=0, max_batch=8, batch_window_ms=100.0,
                    request_timeout=600.0) as server:
        host, port = server.address[0], server.address[1]
        base = f"http://{host}:{port}"
        results = [None] * 4
        errors = []

        def greedy(i):
            try:
                results[i] = _post(base + "/v1/generate",
                                   {"text": prompts[i], "max_new_tokens": wants[i]})
            except Exception as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)

        threads = [threading.Thread(target=greedy, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"greedy requests failed: {errors}")
        lat = {}
        for i, (status, body, dt) in enumerate(results):
            toks = body["tokens"]
            _require(status == 200 and len(toks) == wants[i], body)
            _require(all(0 <= t < ts.text_tokens for t in toks), toks)
            lat[f"generate greedy #{i} {wants[i]} tok (coalesced)"] = dt

        status, body, dt = _post(base + "/v1/generate", {
            "text": prompts[0], "max_new_tokens": 16, "deterministic": False,
            "temperature": 0.8, "top_p": 0.9})
        _require(status == 200 and len(body["tokens"]) == 16, body)
        _require(all(0 <= t < ts.text_tokens for t in body["tokens"]), body)
        lat["generate sampled 16 tok"] = dt

        status, body, dt = _post(base + "/v1/action", {
            "continuous_obs": obs, "action_kind": "continuous", "action_tokens": 6})
        act = np.asarray(body["action"])
        _require(status == 200 and act.shape == (6,), body)
        _require(np.all((act >= -1.0) & (act <= 1.0)), act)
        lat["action continuous 8x17 obs -> 6"] = dt

        status, body, dt = _post(base + "/v1/action", {
            "images": frames, "action_kind": "discrete", "action_tokens": 1,
            "num_actions": 18})
        _require(status == 200 and isinstance(body["action"], int), body)
        _require(0 <= body["action"] < 18, body)
        lat["action discrete 4x96x96x3 frames"] = dt

        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
            _require(r.status == 200 and health["status"] == "ok", health)
        calls = server.coalesced_calls
    launches = whk.whole_head_attention.launches
    for name, dt in lat.items():
        print(f"latency {name}: {dt * 1e3:.1f} ms ({card})")
    print(f"kernel launches {launches} over {calls} prefill calls x {cfg.layers} layers")
    if launches == 0 or launches != cfg.layers * calls:
        raise AssertionError(
            f"prefills did not all run through the kernel: {launches} launches, "
            f"{calls} prefill calls x {cfg.layers} layers")
    return launches, gen, [{"text": p} for p in prompts]


@contextlib.contextmanager
def prefill_attention_through(fn):
    """Within the block the model's prefill attention runs `fn(q, k, v,
    key_mask)` in place of the kernel wrapper."""
    from neko_tpu_torch.ops import attention as attn_ops

    wrapper = attn_ops.prefill_attention
    attn_ops.prefill_attention = fn
    try:
        yield
    finally:
        attn_ops.prefill_attention = wrapper


def plain_prefill_attention(q, k, v, key_mask, fault=None):
    """The kernel's plain version over the packer mask, or that version with
    one of FAULTS planted in it."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    start, end = whk.mask_bounds_from_key_mask(key_mask)
    if fault is None:
        return whk.whole_head_attention_reference(q, k, v, start, end)
    idx = torch.arange(q.shape[2], device=q.device)
    row, col = idx[:, None], idx[None, :]
    st, en = start.long()[:, None, None, None], end.long()[:, None, None, None]
    window = (col >= st) & (col < en)
    allowed, scale = {
        "causal mask dropped": (window, None),
        "diagonal excluded": ((col < row) & window, None),
        "key window ignored": ((col <= row)[None, None], None),
        "scale 1/hd": ((col <= row) & window, 1.0 / q.shape[-1]),
    }[fault]
    return whk.masked_attention(q, k, v, allowed, scale)


def prefill_check(gen, examples) -> None:
    """Phase 4, on the greedy batch."""
    import torch

    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.ops import attention as attn_ops
    from neko_tpu_torch.ops import attention_kernel as whk

    model = gen.model
    arrays = gen.packer.pack_batch(examples, pad_side="right")
    lengths = arrays.pop("lengths")
    S, V = model.cfg.context_len, model.cfg.vocab_size
    layer_errs, fault_excess = [], {f: [] for f in FAULTS}
    wrapper = attn_ops.prefill_attention

    def checked(q, k, v, key_mask):
        out = wrapper(q, k, v, key_mask)
        start, end = whk.mask_bounds_from_key_mask(key_mask)
        ref = plain_prefill_attention(q, k, v, key_mask)
        if not torch.isfinite(out).all():
            raise AssertionError(f"layer {len(layer_errs)}: kernel output not finite")
        layer_errs.append(_against_plain(out, ref, start, end))
        for f in FAULTS:
            bad = plain_prefill_attention(q, k, v, key_mask, fault=f)
            fault_excess[f].append(_against_plain(bad, ref, start, end)[1])
        return out

    with torch.inference_mode():
        batch = to_device_batch(arrays, gen.device)
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(gen.device)
        last = torch.as_tensor(lengths - 1, device=gen.device)
        emb = model.embed_batch(batch)
        with prefill_attention_through(checked):
            got, _ = model.prefill(emb, mask, last=last)
        with prefill_attention_through(plain_prefill_attention):
            want, _ = model.prefill(emb, mask, last=last)
        fault_err = {}
        for f in FAULTS:
            with prefill_attention_through(
                    lambda *a, f=f: plain_prefill_attention(*a, fault=f)):
                bad, _ = model.prefill(emb, mask, last=last)
            fault_err[f] = (bad[:, :V] - want[:, :V]).abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel prefill logits not finite")

    for i, (err, excess) in enumerate(layer_errs):
        print(f"layer {i} attention on the served inputs, kernel vs plain: "
              f"max abs err {err:.3e} (excess over tolerance {excess:.3e})")
    err = (got[:, :V] - want[:, :V]).abs().max().item()
    # argmax agreement is printed, not held: random-init logits have top-2
    # gaps below the bf16 noise on some rows
    agree = (got[:, :V].argmax(-1) == want[:, :V].argmax(-1)).float().mean().item()
    print(f"prefill logits kernel vs plain: max abs err {err:.3e} "
          f"(tolerance {LOGIT_TOL:g}; logit std {want[:, :V].std().item():.3f}), "
          f"argmax agreement {agree:.2f}")
    for f in FAULTS:
        print(f"control '{f}': per-layer excess over tolerance "
              f"{max(fault_excess[f]):.3e}, logits max abs err {fault_err[f]:.3e}")

    if not all(excess <= 0 for _, excess in layer_errs):
        raise AssertionError(f"kernel disagrees with the plain version on a layer: {layer_errs}")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"prefill logits disagree: {err}")
    blind = [f for f in FAULTS if not max(fault_excess[f]) > 0]
    blind += [f for f in LOGIT_FAULTS if not fault_err[f] > LOGIT_TOL]
    if blind:
        raise AssertionError(f"the checks cannot tell these planted faults: {blind}")


# ------------------------------------------------------------- training
def _train_bounds(B, S, dev):
    """Left-padded rows as the packer writes them for training, with a short
    row (37 keys) and an empty row (no key)."""
    import torch

    starts = ([0, 100, 600, S - 37, S, 0, 200, 400, 50, 0, 700, 900, 10, 0, 333, S - 1]
              * B)[:B]
    ends = [0 if st >= S else S for st in starts]
    return (torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(ends, dtype=torch.int32, device=dev))


def _valid_rows(start, end, S):
    """bool [B, S]: the query row sees a key."""
    import torch

    rows = torch.arange(S, device=start.device)[None, :]
    return (rows >= start[:, None].long()) & (start < end)[:, None]


def _excess(got, want, tol):
    """-> (max abs error, largest excess over atol + rtol * |want|)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff - atol - rtol * want.float().abs()).max().item()


def plain_attention_backward(q, k, v, do, start, end, sm_scale, ks, fault=None):
    """dq, dk, dv of the plain attention by the math of the TPU kernel's
    `_blk_grads`, in fp32 on [B, H, S, hd]; rows that see no key have p = 0
    (their output is 0).  `fault` plants one of STEP_FAULTS."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    ok = whk.allowed_keys(q.shape[-2], start, end)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2) * sm_scale).masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1) * ok.any(dim=-1, keepdim=True)
    del s
    drop = ks is not None and fault != "keep mask not applied in the backward"
    dv = (p * ks if drop else p).transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    if drop:
        dp = dp * ks
    delta = 0.0 if fault == "delta taken as 0" else (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    del dp, p
    dq, dk = ds @ kf, ds.transpose(-1, -2) @ qf
    if fault == "dk without sm_scale":
        dk = dk / sm_scale
    return dq, dk, dv


def plain_attention_forward(q, k, v, start, end, ks, fault=None):
    """The plain forward on [B, H, S, hd] with the keep/scale `ks`, or with
    one of STEP_LOSS_FAULTS planted in it."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    if fault == "keep mask not applied in the forward":
        ks = None
    sm_scale = 1.0 / q.shape[-1] if fault == "scale 1/hd in the forward" else None
    if fault != "causal mask dropped in the forward":
        return whk.whole_head_attention_reference(q, k, v, start, end, sm_scale, ks)
    col = torch.arange(q.shape[-2], device=q.device)[None, None, None, :]
    ok = (col >= start.long()[:, None, None, None]) & (col < end.long()[:, None, None, None])
    out = whk.masked_attention(q, k, v, ok, sm_scale, keep_scale=ks)
    return out.masked_fill(~ok.any(dim=-1, keepdim=True), 0)


def plain_attention_qkv_fn(fault=None):
    """A stand-in for ops.attention.attention_qkv: the plain forward with the
    mask from the mask kernel, and `plain_attention_backward` as its
    backward, with `fault` (one of STEP_FAULTS or STEP_LOSS_FAULTS) planted.
    Both run in fp32 on the bf16 inputs and round the result once, as the
    kernels do, so the step check's sound reading is the kernels' summation
    order alone."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    class PlainQKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, start, end, seed, heads, rate):
            q, k, v = (t.float() for t in whk._qkv_views("qkv", (qkv,), heads))
            B, H, S, hd = q.shape
            ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate > 0 else None
            out = plain_attention_forward(q, k, v, start, end, ks, fault).to(qkv.dtype)
            ctx.save_for_backward(qkv, start, end, seed)
            ctx.static = (heads, rate)
            return out.transpose(1, 2).reshape(B, S, H * hd)

        @staticmethod
        def backward(ctx, dout):
            qkv, start, end, seed = ctx.saved_tensors
            heads, rate = ctx.static
            q, k, v = whk._qkv_views("qkv", (qkv,), heads)
            B, H, S, hd = q.shape
            ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate > 0 else None
            grads = plain_attention_backward(q, k, v, whk._heads4(dout, heads), start, end,
                                             hd ** -0.5, ks, fault)
            dqkv = torch.cat([g.transpose(1, 2).reshape(B, S, H * hd) for g in grads], -1)
            return dqkv.to(qkv.dtype), None, None, None, None, None

    def attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
        start, end = whk.mask_bounds_from_key_mask(key_mask)
        return PlainQKV.apply(qkv, start, end, seed, heads, rate)

    return attention_qkv


@contextlib.contextmanager
def train_attention_through(fn):
    """Within the block the model's train attention runs `fn` in place of
    ops.attention.attention_qkv."""
    from neko_tpu_torch.ops import attention as attn_ops

    wrapper = attn_ops.attention_qkv
    attn_ops.attention_qkv = fn
    try:
        yield
    finally:
        attn_ops.attention_qkv = wrapper


def train_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 5.  -> errors and times of the three training kernels."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    B, H, S, hd = TRAIN["B"], TRAIN["H"], TRAIN["S"], TRAIN["hd"]
    D = H * hd
    g = torch.Generator(device=dev).manual_seed(SEED)
    qkv = torch.randn(B, S, 3 * D, device=dev, generator=g).bfloat16()
    start, end = _train_bounds(B, S, dev)
    valid = _valid_rows(start, end, S)
    dout = torch.randn(B, S, D, device=dev, generator=g).bfloat16() * valid[..., None]
    seed = torch.tensor([SEED + 17], dtype=torch.int32, device=dev)
    res = {}

    ks = whk.dropout_keep_scale(seed, B, H, S, RATE)
    ks_plain = whk.dropout_keep_scale_reference(seed, B, H, S, RATE)
    _require(torch.equal(ks, ks_plain), "mask kernel differs from the plain Philox")
    del ks_plain
    q_thr = whk.keep_threshold(RATE)
    p_keep, n = 1.0 - q_thr / 256.0, ks.numel()
    share = (ks > 0).double().mean().item()
    print(f"mask kernel {B}x{H}x{S}x{S}: equal to the plain Philox bit for bit; keep "
          f"share {share:.6f} (expected {p_keep:.6f} +- {5 * (p_keep * (1 - p_keep) / n) ** 0.5:.2e})")
    _require(abs(share - p_keep) < 5 * (p_keep * (1 - p_keep) / n) ** 0.5, "keep share")

    fwd_err = bwd_err = 0.0
    for rate in (0.0, RATE):
        x = qkv.clone().requires_grad_()
        out = whk.whole_head_attention_qkv(x, start, end, seed, heads=H, dropout_rate=rate)
        (dx,) = torch.autograd.grad(out, (x,), dout)
        torch.cuda.synchronize()
        _require(torch.isfinite(out).all() and torch.isfinite(dx).all(), "kernel output not finite")
        xp = qkv.clone().requires_grad_()
        q4, k4, v4 = whk._qkv_views("qkv", (xp,), H)
        ref = whk.whole_head_attention_reference(q4, k4, v4, start, end, None,
                                                 ks if rate else None)
        ref = ref.transpose(1, 2).reshape(B, S, D)
        (dxp,) = torch.autograd.grad(ref, (xp,), dout)
        err, excess = _excess(out[valid], ref[valid], KERNEL_TOL["bfloat16"])
        fwd_err = max(fwd_err, err)
        print(f"train forward rate {rate}: kernel vs plain max abs err {err:.3e} "
              f"(excess over tolerance {excess:.3e})")
        _require(excess <= 0, f"train forward disagrees at rate {rate}")
        with torch.no_grad():  # the plain backward phase 6 plants faults into
            explicit = plain_attention_backward(
                q4, k4, v4, whk._heads4(dout, H), start, end, hd ** -0.5, ks if rate else None)
        for name, got, want, mine in zip("qkv", dx.chunk(3, -1), dxp.chunk(3, -1), explicit):
            err, excess = _excess(got, want, GRAD_TOL["bfloat16"])
            e2, x2 = _excess(mine.transpose(1, 2).reshape(B, S, D), want.float(),
                             GRAD_TOL["bfloat16"])
            bwd_err = max(bwd_err, err)
            print(f"train backward rate {rate} d{name}: kernel vs autograd through plain "
                  f"max abs err {err:.3e} (excess {excess:.3e}); explicit plain backward "
                  f"{e2:.3e} (excess {x2:.3e})")
            _require(excess <= 0 and x2 <= 0, f"train backward d{name} disagrees at rate {rate}")
        del x, xp, out, ref, dx, dxp, explicit
    res["fwd_err"], res["bwd_err"] = fwd_err, bwd_err

    for Bx, Hx, hdx in ((8, 12, 64), (8, 6, 128)):
        gq = [torch.randn(Bx, Hx, S, hdx, device=dev, generator=g).requires_grad_()
              for _ in range(3)]
        st, en = _train_bounds(Bx, S, dev)
        ok = _valid_rows(st, en, S)[:, None, :, None]
        do4 = torch.randn(Bx, Hx, S, hdx, device=dev, generator=g) * ok
        o = whk.whole_head_attention(*gq, st, en, seed, dropout_rate=RATE)
        grads = torch.autograd.grad(o, gq, do4)
        ksx = whk.dropout_keep_scale(seed, Bx, Hx, S, RATE)
        r = whk.whole_head_attention_reference(*gq, st, en, None, ksx)
        rgrads = torch.autograd.grad(r, gq, do4)
        errs = [_excess(o[ok.expand_as(o)], r[ok.expand_as(r)], KERNEL_TOL["float32"])]
        errs += [_excess(a, b, GRAD_TOL["float32"]) for a, b in zip(grads, rgrads)]
        print(f"[B,H,S,hd] {Bx}x{Hx}x{S}x{hdx} fp32 rate {RATE}: out, dq, dk, dv max abs "
              f"err {', '.join(f'{e:.2e}' for e, _ in errs)}")
        _require(all(x <= 0 for _, x in errs), f"hd {hdx} fp32 kernel disagrees")
        del gq, o, grads, r, rgrads, ksx

    # times at the train shape, rate 0.1, in turns: plain, kernel, kernel, plain; on
    # full rows, as in the flagship batch (its rows hold 988 to 1023 tokens)
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    end = torch.full((B,), S, dtype=torch.int32, device=dev)
    q4, k4, v4 = whk._qkv_views("qkv", (qkv,), H)
    out = torch.empty(B, S, D, dtype=qkv.dtype, device=dev)
    o4, do4 = whk._heads4(out, H), whk._heads4(dout, H)
    _, lse = whk.whole_head_attention_fwd(q4, k4, v4, start, end, seed, None, RATE,
                                          out=o4, need_lse=True)
    dqkv = torch.empty_like(qkv)
    dq4, dk4, dv4 = whk._qkv_views("qkv", (dqkv,), H)
    xp = qkv.clone().requires_grad_()
    ref = whk.whole_head_attention_reference(*whk._qkv_views("qkv", (xp,), H), start, end,
                                             None, ks)

    def turns(kernel, plain, iters):
        p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kernel, kernel, plain))
        return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)

    timed = {
        "fwd": turns(lambda: whk.whole_head_attention_fwd(
                         q4, k4, v4, start, end, seed, None, RATE, out=o4, need_lse=True),
                     lambda: whk.whole_head_attention_reference(q4, k4, v4, start, end,
                                                                None, ks), 10),
        "bwd": turns(lambda: whk.whole_head_attention_bwd(
                         q4, k4, v4, o4, do4, lse, start, end, seed, None, RATE,
                         dq=dq4, dk=dk4, dv=dv4),
                     lambda: torch.autograd.grad(ref, (xp,), do4, retain_graph=True), 10),
        "mask": turns(lambda: whk.dropout_keep_scale(seed, B, H, S, RATE),
                      lambda: whk.dropout_keep_scale_reference(seed, B, H, S, RATE), 3),
    }
    lib = dict(zip(("fwd", "bwd"), _sdpa_ms(q4, k4, v4, do4, RATE, 10)))
    bounds = _attention_bounds(_pairs(start, end, S, H), B, H, S, hd, 2)
    bounds = {"fwd": bounds["whole_fwd"], "bwd": bounds["whole_bwd"],
              "mask": _bound(0, B * H * S * S * 4)}
    for part, (ms, plain_ms, each) in timed.items():
        print(f"train {part} B={B} H={H} S={S} hd={hd} bf16 rate {RATE}, full rows: kernel "
              f"{ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (in turns k {each[0]:.4f}/{each[1]:.4f}, "
              f"p {each[2]:.4f}/{each[3]:.4f}), library "
              f"{'-' if part not in lib else f'{lib[part]:.4f} ms'}, bound "
              f"{bounds[part][0]:.4f} ms ({bounds[part][1]}) ({card})")
        res[part] = (ms, plain_ms, lib.get(part), *bounds[part])
    return res


def _grad_gap(grads, want) -> float:
    """Largest relative L2 error of a parameter's gradient."""
    return max(((grads[n].float() - w.float()).norm() / w.float().norm().clamp(min=1e-30)).item()
               for n, w in want.items())


def train_step_check(card: str, dev="cuda") -> dict:
    """Phase 6.  -> launch counts of the training kernels in the timed train
    steps ("fwd", "bwd", "mask"), and of the mask kernel in the step check
    ("mask_check")."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg, ctx, state, batch, B = bench.setup("flagship", dev, SEED)
    warm, steps = 2, 5
    _, warm_losses = bench.time_steps(ctx, state, batch, warm)
    torch.cuda.reset_peak_memory_stats()
    whk.whole_head_attention.launches = whk.whole_head_attention_bwd.launches = 0
    whk.dropout_keep_scale.launches = 0
    dt, losses = bench.time_steps(ctx, state, batch, steps)
    fwd, bwd = whk.whole_head_attention.launches, whk.whole_head_attention_bwd.launches
    mask = whk.dropout_keep_scale.launches
    tokens = B * cfg.context_len
    fpt = bench.train_flops_per_token(cfg, bench.tgt_budget(B, cfg) / tokens)
    tps = tokens * steps / dt
    peak = bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    print(f"flagship train step {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h k={cfg.context_len} "
          f"B={B} bf16 dropout {cfg.dropout}: {dt * 1e3 / steps:.3f} ms/step, "
          f"{tps:.1f} tokens/s, MFU {tps * fpt / peak if peak else float('nan'):.4f} "
          f"({fpt / 1e6:.1f} MFLOP/token), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
    print(f"losses: warm-up {warm_losses}, timed {losses}")
    _require(all(np.isfinite(warm_losses + losses)), f"non-finite loss: {losses}")
    print(f"train kernel launches over {steps} steps x {cfg.layers} layers: forward {fwd}, "
          f"backward {bwd}, mask {mask} (the kernels draw their keep bytes inline)")
    _require(fwd == bwd == cfg.layers * steps,
             f"the train steps did not all run through the kernels: {fwd}, {bwd}")
    _require(mask == 0, f"the train steps launched the mask kernel {mask} times")
    del state

    sd = init_state_dict(cfg, SEED)

    def loss_and_grads(fn=None):
        st = ctx.init_state({k: v.clone() for k, v in sd.items()})
        with contextlib.ExitStack() as stack:
            if fn is not None:
                stack.enter_context(train_attention_through(fn))
            loss = ctx.loss_and_grads(st, batch).item()
        return loss, {n: p.grad for n, p in st.model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    whk.dropout_keep_scale.launches = 0
    loss_p, grads_p = loss_and_grads(plain_attention_qkv_fn())
    mask_launches = whk.dropout_keep_scale.launches
    gap, dloss = _grad_gap(grads_k, grads_p), abs(loss_k - loss_p)
    print(f"one step, kernels vs plain attention (same seeds and masks): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (diff {dloss:.3e}, tolerance {STEP_LOSS_TOL:g}); largest relative "
          f"gradient error {gap:.3e} (tolerance {STEP_GRAD_TOL:g}); mask kernel launches "
          f"{mask_launches}")
    del grads_k
    fault_gap, fault_dloss = {}, {}
    for f in STEP_FAULTS + STEP_LOSS_FAULTS:
        loss_f, grads_f = loss_and_grads(plain_attention_qkv_fn(f))
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_p), abs(loss_f - loss_p)
        print(f"control '{f}': loss diff {fault_dloss[f]:.3e}, largest relative gradient "
              f"error {fault_gap[f]:.3e}")
        del grads_f
    _require(dloss <= STEP_LOSS_TOL and gap <= STEP_GRAD_TOL,
             f"the kernel step disagrees with the plain step: {dloss}, {gap}")
    _require(mask_launches == 2 * cfg.layers, f"mask kernel launches {mask_launches}")
    blind = [f for f in STEP_FAULTS if not fault_gap[f] > STEP_GRAD_TOL]
    blind += [f for f in STEP_LOSS_FAULTS if not fault_dloss[f] > STEP_LOSS_TOL]
    _require(not blind, f"the step check cannot tell these planted faults: {blind}")

    opt = OptimizerConfig(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                          disable_cosine_decay=True)
    ctx2 = TrainContext(cfg, opt, device=dev, seed=SEED)
    state2 = ctx2.init_state()
    _, curve = bench.time_steps(ctx2, state2, batch, 20)
    print("20 steps on one batch at lr 1e-3: loss " + ", ".join(f"{x:.4f}" for x in curve[::4])
          + f", ..., {curve[-1]:.4f}")
    _require(all(np.isfinite(curve)) and curve[-1] < curve[0] - 1.0,
             f"the loss did not fall: {curve}")
    return {"fwd": fwd, "bwd": bwd, "mask": mask, "mask_check": mask_launches}


# ------------------------------------------------------- long context
def blocked_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 7.  -> {"err": max abs error per kernel, "times": {S: {kernel:
    JSON timing fields}}, "check_launches": launches per kernel here}."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba

    counters = {"fwd": ba.blocked_attention_fwd, "fused": ba.blocked_attention_bwd_fused,
                "dq": ba.blocked_attention_dq, "dkv": ba.blocked_attention_dkv,
                "mask": whk.dropout_keep_scale}
    for f in counters.values():
        f.launches = 0
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    seed = torch.tensor([SEED + 29], dtype=torch.int32, device=dev)
    errs = dict.fromkeys(("fwd", "fused", "dq", "dkv"), 0.0)

    def inputs(B, H, S, hd, dtype, full_rows=False):
        qkv = torch.randn(B, S, 3 * H * hd, device=dev, generator=g).to(dtype)
        if full_rows:
            start = torch.zeros(B, dtype=torch.int32, device=dev)
            end = torch.full((B,), S, dtype=torch.int32, device=dev)
        else:
            start, end = _train_bounds(B, S, dev)
        valid = _valid_rows(start, end, S)
        dout = torch.randn(B, S, H * hd, device=dev, generator=g).to(dtype) * valid[..., None]
        return qkv, start, end, valid, dout

    def case(B, H, S, hd, dtype_name, rate):
        qkv, start, end, valid, dout = inputs(B, H, S, hd, getattr(torch, dtype_name))
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        do = whk._heads4(dout, H)
        ks = ba.dropout_keep_scale(seed, B, H, S, rate) if rate else None
        if rate and dtype_name == "bfloat16":
            _require(torch.equal(ks, whk.dropout_keep_scale_reference(seed, B, H, S, rate)),
                     f"mask kernel differs from the plain Philox at {B}x{H}x{S}")
            print(f"mask kernel {B}x{H}x{S}x{S}: equal to the plain Philox bit for bit")
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, rate)
        delta = ba.row_delta(do, out)
        bwd = (q, k, v, do, m, l, delta, start, end, seed, None, rate)
        routes = {"fused": ba.blocked_attention_bwd_fused(*bwd),
                  "three-pass": (ba.blocked_attention_dq(*bwd), *ba.blocked_attention_dkv(*bwd))}
        torch.cuda.synchronize()
        _require(all(torch.isfinite(t).all() for t in (out, m, l, *routes["fused"],
                                                        *routes["three-pass"])),
                 f"blocked kernel output not finite at {B}x{H}x{S}x{hd}")
        ref, m_ref, l_ref = ba.blocked_fwd_reference(q, k, v, start, end, None, ks)
        # each backward kernel on its own inputs: the kernel forward's (m, l,
        # delta), and q, k, v, do in fp32 (the same values)
        plain_bwd = (*(t.float() for t in (q, k, v, do)), m, l, delta, start, end, None, ks)
        want = ba.blocked_bwd_fused_reference(*plain_bwd)
        with planted(BLOCKED_FAULT, S):
            faulty = ba.blocked_bwd_fused_reference(*plain_bwd)
        del ks, plain_bwd
        ok = valid[:, None, :, None].expand_as(out)
        rows = valid[:, None, :].expand_as(m)
        res = {"out": _excess(out[ok], ref[ok], KERNEL_TOL[dtype_name]),
               "m": _excess(m[rows], m_ref[rows], STAT_TOL["m"]),
               "l": _excess(l[rows], l_ref[rows], STAT_TOL["l"])}
        fault = {}
        for route, got in routes.items():
            for name, a, w, f in zip(("dq", "dk", "dv"), got, want, faulty):
                res[f"{route} {name}"] = _excess(a, w, BLOCKED_GRAD_TOL[dtype_name])
                fault[f"{route} {name}"] = _excess(a, f, BLOCKED_GRAD_TOL[dtype_name])[1]
        empty = bool(not out[~ok].any() and (m[~rows] == whk._NEG).all() and not l[~rows].any())
        print(f"blocked {B}x{H}x{S}x{hd} {dtype_name} rate {rate}, kernel vs plain (max abs err / "
              f"excess over tolerance): " + ", ".join(
                  f"{n} {e:.2e}/{x:.1e}" for n, (e, x) in res.items())
              + f"; rows with no key all 0 (m -1e30, l 0): {empty}; control '{BLOCKED_FAULT}' "
              f"excess: " + ", ".join(f"{n} {x:.1e}" for n, x in fault.items()))
        _require(empty and all(x <= 0 for _, x in res.values()),
                 f"blocked kernels disagree with the plain versions at {B}x{H}x{S}x{hd} "
                 f"{dtype_name} rate {rate}")
        _require(all(x > 0 for x in fault.values()),
                 f"the gradient checks cannot tell '{BLOCKED_FAULT}': {fault}")
        errs["fwd"] = max(errs["fwd"], res["out"][0])
        errs["fused"] = max([errs["fused"]] + [res[f"fused {n}"][0] for n in ("dq", "dk", "dv")])
        errs["dq"] = max(errs["dq"], res["three-pass dq"][0])
        errs["dkv"] = max([errs["dkv"]] + [res[f"three-pass {n}"][0] for n in ("dk", "dv")])

    for B, H, S, hd in BLOCKED_BF16:
        for rate in (0.0, RATE):
            case(B, H, S, hd, "bfloat16", rate)
    for B, H, S, hd in BLOCKED_FP32:
        case(B, H, S, hd, "float32", RATE)

    # one seed, one mask: at S = 1024 the blocked and whole-head kernels agree
    qkv, start, end, valid, dout = inputs(4, 24, 1024, 32, torch.bfloat16)
    res = []
    for fn in (ba.blocked_attention_qkv, whk.whole_head_attention_qkv):
        x = qkv.clone().requires_grad_()
        out = fn(x, start, end, seed, heads=24, dropout_rate=RATE)
        res.append((out, *torch.autograd.grad(out, (x,), dout)))
    (o1, g1), (o2, g2) = res
    e_o, x_o = _excess(o1[valid], o2[valid], KERNEL_TOL["bfloat16"])
    e_g, x_g = _excess(g1, g2, GRAD_TOL["bfloat16"])
    print(f"blocked vs whole-head kernels 4x24x1024x32 bf16 rate {RATE}, same seed: out "
          f"{e_o:.2e}, dqkv {e_g:.2e}")
    _require(x_o <= 0 and x_g <= 0, "blocked and whole-head kernels differ at S=1024")
    del res, o1, o2, g1, g2

    def routes(S, fused, three):
        print(f"backward routes at S={S}: fused {fused:.4f} ms, three-pass {three:.4f} ms "
              f"(fused/three-pass {fused / three:.3f}); FUSED_MAX = {ba.FUSED_MAX} takes the "
              f"{'fused' if S <= ba.FUSED_MAX else 'three-pass'} route")

    times = {}
    for B, H, S, hd in BLOCKED_TIMED:  # full rows, bf16, rate 0.1, in turns
        qkv, start, end, _, dout = inputs(B, H, S, hd, torch.bfloat16, full_rows=True)
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        do = whk._heads4(dout, H)
        ks = ba.dropout_keep_scale(seed, B, H, S, RATE)
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, RATE)
        bwd = (q, k, v, do, m, l, ba.row_delta(do, out), start, end)
        it = max(2, 10 * 2048 // S)
        runs = {
            "fwd": (lambda: ba.blocked_attention_fwd(q, k, v, start, end, seed, None, RATE),
                    lambda: ba.blocked_fwd_reference(q, k, v, start, end, None, ks)),
            "fused": (lambda: ba.blocked_attention_bwd_fused(*bwd, seed, None, RATE),
                      lambda: ba.blocked_bwd_fused_reference(*bwd, None, ks)),
            "dq": (lambda: ba.blocked_attention_dq(*bwd, seed, None, RATE),
                   lambda: ba.blocked_dq_reference(*bwd, None, ks)),
            "dkv": (lambda: ba.blocked_attention_dkv(*bwd, seed, None, RATE),
                    lambda: ba.blocked_dkv_reference(*bwd, None, ks)),
        }
        bounds = _attention_bounds(_pairs(start, end, S, H), B, H, S, hd, 2)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do, RATE, it)
        library = {"fwd": lib_fwd, "fused": lib_bwd, "dq": lib_bwd, "dkv": lib_bwd}
        if S == BLOCKED_TIMED[0][2]:  # the mask kernel (#5, #10) at the `long` shape
            runs["mask"] = (lambda: ba.dropout_keep_scale(seed, B, H, S, RATE),
                            lambda: whk.dropout_keep_scale_reference(seed, B, H, S, RATE))
            bounds["mask"], library["mask"] = _bound(0, B * H * S * S * 4), None
        times[S] = {}
        for name, (kernel, plain) in runs.items():
            p1, k1, k2, p2 = (_time_ms(f, n) for f, n in ((plain, 2), (kernel, it), (kernel, it),
                                                          (plain, 2)))
            times[S][name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                              "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                              "library_ms": library[name]}
            lib = "-" if library[name] is None else f"{library[name]:.4f} ms"
            print(f"blocked {name} {B}x{H}x{S}x{hd} bf16 rate {RATE}, full rows: kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA {lib}, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}) ({card})")
        routes(S, times[S]["fused"]["ms"], times[S]["dq"]["ms"] + times[S]["dkv"]["ms"])
        del ks, qkv, dout, out, m, l, bwd, runs
        torch.cuda.empty_cache()
    for B, H, S, hd in BLOCKED_ROUTES_ONLY:  # the two routes alone, no plain versions
        qkv, start, end, _, dout = inputs(B, H, S, hd, torch.bfloat16, full_rows=True)
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        do = whk._heads4(dout, H)
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, RATE)
        bwd = (q, k, v, do, m, l, ba.row_delta(do, out), start, end, seed, None, RATE)
        run_f = lambda: ba.blocked_attention_bwd_fused(*bwd)  # noqa: E731
        run_t = lambda: (ba.blocked_attention_dq(*bwd), ba.blocked_attention_dkv(*bwd))  # noqa: E731
        f1, t1, t2, f2 = (_time_ms(f, 2) for f in (run_f, run_t, run_t, run_f))  # in turns
        print(f"blocked backward routes {B}x{H}x{S}x{hd} bf16 rate {RATE}, full rows: fused "
              f"{f1:.4f}/{f2:.4f} ms, three-pass {t1:.4f}/{t2:.4f} ms ({card})")
        routes(S, (f1 + f2) / 2, (t1 + t2) / 2)
        del qkv, dout, out, m, l, bwd
        torch.cuda.empty_cache()
    return {"err": errs, "times": times,
            "check_launches": {n: f.launches for n, f in counters.items()}}


@contextlib.contextmanager
def planted(fault, S):
    """Within the block the plain blocked versions carry `fault` when it is
    one of the structure faults of LONG_STEP_FAULTS / LONG_STEP_LOSS_FAULTS
    (a dropped rescale; key tiles past the diagonal visited, the causal mask
    left to the loop bounds) or BLOCKED_FAULT (each row's keys from the
    start of its diagonal 32-key tile, the kernels' key tile, masked out)."""
    import torch

    from neko_tpu_torch.ops import blocked_attention as ba

    saved = {n: getattr(ba, n) for n in ("_online_update", "_key_tiles", "_tile_mask")}
    if fault == "running-max rescale alpha dropped":
        def no_alpha(m, l, acc, s, ok, v_blk, ks):
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new).masked_fill(~ok, 0.0)
            l = l + p.sum(-1, keepdim=True)
            if ks is not None:
                p = p * ks
            return m_new, l, acc + torch.matmul(p.to(v_blk.dtype).float(), v_blk.float())

        ba._online_update = no_alpha
    elif fault == "key tiles above the diagonal included":
        tile_mask = saved["_tile_mask"]

        def window_only_above_diagonal(r0, r1, c0, c1, start, end):
            ok = tile_mask(r0, r1, c0, c1, start, end)
            if c0 < r1:
                return ok
            col = torch.arange(c0, c1, device=start.device)
            return ((col >= start.long()[:, None, None, None])
                    & (col < end.long()[:, None, None, None])).expand_as(ok)

        ba._key_tiles = lambda r1: range(0, S, ba.BLOCK)
        ba._tile_mask = window_only_above_diagonal
    elif fault == BLOCKED_FAULT:
        tile_mask = saved["_tile_mask"]

        def diagonal_tile_skipped(r0, r1, c0, c1, start, end):
            row = torch.arange(r0, r1, device=start.device)[:, None]
            col = torch.arange(c0, c1, device=start.device)[None, :]
            return tile_mask(r0, r1, c0, c1, start, end) & (col < row // 32 * 32)

        ba._tile_mask = diagonal_tile_skipped
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ba, n, f)


def plain_blocked_qkv_fn(fault=None):
    """A stand-in for ops.attention.attention_qkv: the plain blocked forward
    and backward (the fused plain version for S <= FUSED_MAX, else dq and
    dkv), in fp32 on the bf16 inputs with the mask from the mask kernel,
    rounded once; `fault` (one of LONG_STEP_FAULTS or LONG_STEP_LOSS_FAULTS)
    planted."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba

    class PlainBlockedQKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, start, end, seed, heads, rate):
            q, k, v = (t.float() for t in whk._qkv_views("qkv", (qkv,), heads))
            B, H, S, hd = q.shape
            ks = ba.dropout_keep_scale(seed, B, H, S, rate) if rate > 0 else None
            with planted(fault, S):
                out, m, l = ba.blocked_fwd_reference(q, k, v, start, end, None, ks)
            ctx.save_for_backward(qkv, start, end, seed, out, m, l)
            ctx.static = (heads, rate)
            return out.to(qkv.dtype).transpose(1, 2).reshape(B, S, H * hd)

        @staticmethod
        def backward(ctx, dout):
            qkv, start, end, seed, out, m, l = ctx.saved_tensors
            heads, rate = ctx.static
            q, k, v = (t.float() for t in whk._qkv_views("qkv", (qkv,), heads))
            B, H, S, hd = q.shape
            do = whk._heads4(dout, heads).float()
            ks = None
            if rate > 0 and fault != "keep mask not applied in the backward":
                ks = ba.dropout_keep_scale(seed, B, H, S, rate)
            delta = ba.row_delta(do, out)
            if fault == "delta taken as 0":
                delta = torch.zeros_like(delta)
            args = (q, k, v, do, m, l, delta, start, end, None, ks)
            with planted(fault, S):
                grads = (ba.blocked_bwd_fused_reference(*args) if S <= ba.FUSED_MAX
                         else (ba.blocked_dq_reference(*args), *ba.blocked_dkv_reference(*args)))
            dqkv = torch.cat([t.transpose(1, 2).reshape(B, S, H * hd) for t in grads], -1)
            return dqkv.to(qkv.dtype), None, None, None, None, None

    def attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
        start, end = whk.mask_bounds_from_key_mask(key_mask)
        return PlainBlockedQKV.apply(qkv, start, end, seed, heads, rate)

    return attention_qkv


def long_train(card: str, dev="cuda") -> dict:
    """Phase 8.  -> launches per kernel in the timed long-context steps."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    counters = {"fwd": ba.blocked_attention_fwd, "fused": ba.blocked_attention_bwd_fused,
                "dq": ba.blocked_attention_dq, "dkv": ba.blocked_attention_dkv,
                "whole-head fwd": whk.whole_head_attention,
                "whole-head bwd": whk.whole_head_attention_bwd, "mask": whk.dropout_keep_scale}
    path = dict.fromkeys(counters, 0)
    peak = bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))

    def timed(config, warm, steps):
        name = config if isinstance(config, str) else f"k={config['context_len']}"
        cfg, ctx, state, batch, B = bench.setup(config, dev, SEED)
        _, warm_losses = bench.time_steps(ctx, state, batch, warm)
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        dt, losses = bench.time_steps(ctx, state, batch, steps)
        got = {n: f.launches for n, f in counters.items()}
        tokens = B * cfg.context_len
        fpt = bench.train_flops_per_token(cfg, bench.tgt_budget(B, cfg) / tokens)
        tps = tokens * steps / dt
        print(f"{name} train step {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h "
              f"k={cfg.context_len} B={B} bf16 dropout {cfg.dropout}: {dt * 1e3 / steps:.3f} "
              f"ms/step over {steps}, {tps:.1f} tokens/s, MFU "
              f"{tps * fpt / peak if peak else float('nan'):.4f} ({fpt / 1e6:.1f} MFLOP/token), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
        print(f"  losses: warm-up {warm_losses}, timed {losses}; launches {got}")
        _require(all(np.isfinite(warm_losses + losses)), f"{name}: non-finite loss {losses}")
        n = cfg.layers * steps
        fused = cfg.context_len <= ba.FUSED_MAX
        want = {"fwd": n, "fused": n if fused else 0, "dq": 0 if fused else n,
                "dkv": 0 if fused else n, "whole-head fwd": 0, "whole-head bwd": 0, "mask": 0}
        _require(got == want, f"{name}: the steps did not run the blocked kernels as "
                              f"FUSED_MAX={ba.FUSED_MAX} routes them: {got}, expected {want}")
        for k in path:
            path[k] += got[k]
        del state
        torch.cuda.empty_cache()
        return cfg, ctx, batch

    cfg, ctx, batch = timed("long", 2, 3)
    timed("long4k", 1, 1)
    timed(LONG8K, 1, 1)
    sd = init_state_dict(cfg, SEED)

    def loss_and_grads(fn=None):
        st = ctx.init_state({k: v.clone() for k, v in sd.items()})
        with contextlib.ExitStack() as stack:
            if fn is not None:
                stack.enter_context(train_attention_through(fn))
            loss = ctx.loss_and_grads(st, batch).item()
        return loss, {n: p.grad for n, p in st.model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    loss_p, grads_p = loss_and_grads(plain_blocked_qkv_fn())
    gap, dloss = _grad_gap(grads_k, grads_p), abs(loss_k - loss_p)
    del grads_k
    print(f"one long step, kernels vs plain blocked attention (same seeds and masks): loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (diff {dloss:.3e}, tolerance {LONG_STEP_LOSS_TOL:g}); "
          f"largest relative gradient error {gap:.3e} (tolerance {LONG_STEP_GRAD_TOL:g})")
    fault_gap, fault_dloss = {}, {}
    for f in dict.fromkeys(LONG_STEP_FAULTS + LONG_STEP_LOSS_FAULTS):
        loss_f, grads_f = loss_and_grads(plain_blocked_qkv_fn(f))
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_p), abs(loss_f - loss_p)
        print(f"control '{f}': loss diff {fault_dloss[f]:.3e}, largest relative gradient "
              f"error {fault_gap[f]:.3e}")
        del grads_f
    del grads_p
    _require(dloss <= LONG_STEP_LOSS_TOL and gap <= LONG_STEP_GRAD_TOL,
             f"the long kernel step disagrees with the plain step: {dloss}, {gap}")
    blind = [f for f in LONG_STEP_FAULTS if not fault_gap[f] > LONG_STEP_GRAD_TOL]
    blind += [f for f in LONG_STEP_LOSS_FAULTS if not fault_dloss[f] > LONG_STEP_LOSS_TOL]
    _require(not blind, f"the long step check cannot tell these planted faults: {blind}")

    opt = OptimizerConfig(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                          disable_cosine_decay=True)
    ctx2 = TrainContext(cfg, opt, device=dev, seed=SEED)
    state2 = ctx2.init_state()
    _, curve = bench.time_steps(ctx2, state2, batch, 20)
    print("long: 20 steps on one batch at lr 1e-3: loss "
          + ", ".join(f"{x:.4f}" for x in curve[::4]) + f", ..., {curve[-1]:.4f}")
    _require(all(np.isfinite(curve)) and curve[-1] < curve[0] - 1.0,
             f"the long loss did not fall: {curve}")
    return path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from neko_tpu_torch.bench import card as card_name
    from neko_tpu_torch.ops import cuda_build

    card = card_name()
    print("card (nvidia-smi name, power.limit):")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for name in libs:
        cuda_build.load_library(name)
    print(f"built {', '.join(so.name for so in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for so in libs.values():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {so.stem.rsplit('-', 1)[0]}:", line.strip())

    err, ms, plain_ms = kernel_vs_plain(
        8, 24, 1024, 32, "bfloat16",
        starts=[0, 0, 0, 0, 0, 0, 0, 300],
        ends=[1024, 700, 1, 1024, 700, 1, 1024, 1024], timed=True)
    print(f"flagship prefill attention: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
    kernel_vs_plain(8, 12, 1024, 64, "float32", starts=[0] * 7 + [100],
                    ends=[1024, 700, 1, 1024, 513, 1, 1024, 1024], timed=False)
    kernel_vs_plain(8, 6, 1024, 128, "float32", starts=[0] * 7 + [100],
                    ends=[1024, 700, 1, 1024, 513, 1, 1024, 1024], timed=False)

    serve_launches, gen, examples = serve(card)
    prefill_check(gen, examples)
    del gen

    trained = train_kernels_vs_plain(card)
    launches = train_step_check(card)
    print(f"forward kernel launches: serving run {serve_launches}, train run {launches['fwd']}")
    blocked = blocked_kernels_vs_plain(card)
    long_path = long_train(card)

    src = "neko_tpu_torch/csrc/"
    tpu = "neko_tpu/ops/attention_kernel.py"
    tpu_b = "neko_tpu/ops/blocked_attention.py"

    def timing(part):  # phase 5's kernel, plain, library and bound at the flagship shape
        ms, plain_ms, library_ms, bound_ms, bound_by = trained[part]
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    long_times = blocked["times"][BLOCKED_TIMED[0][2]]  # at the `long` shape
    entries = [
        {"name": "whole_head_attention", "route": "cuda",
         "source": src + "whole_head_attention.cu", "replaces": f"{tpu}:206,236",
         "launches": serve_launches + launches["fwd"],
         "max_abs_err": max(err, trained["fwd_err"]), **timing("fwd")},
        {"name": "whole_head_attention_bwd", "route": "cuda",
         "source": src + "whole_head_attention_bwd.cu", "replaces": f"{tpu}:220,256",
         "launches": launches["bwd"], "max_abs_err": trained["bwd_err"], **timing("bwd")},
    ] + [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": f"{tpu_b}:{line}", "launches": long_path[key],
         "check_launches": blocked["check_launches"][key],
         "max_abs_err": blocked["err"][key], **long_times[key]}
        for name, source, line, key in (
            ("blocked_attention_fwd", "blocked_attention.cu", 183, "fwd"),
            ("blocked_attention_bwd_fused", "blocked_attention_bwd.cu", 290, "fused"),
            ("blocked_attention_dq", "blocked_attention_bwd.cu", 241, "dq"),
            ("blocked_attention_dkv", "blocked_attention_bwd.cu", 390, "dkv"))
    ]
    # kernel #5 writes the masks the checks hand to the plain attention, at
    # every S (so it is #10's counterpart too); the train steps' kernels draw
    # the same keep bytes inline and never launch it, as neko_tpu's train
    # step never runs its counterparts.  A blocked backward route that
    # FUSED_MAX dispatches at no trained S runs in the checks alone.
    mask = {"name": "dropout_keep_scale", "route": "cuda",
            "source": src + "dropout_keep_scale.cu", "replaces": f"{tpu}:492,{tpu_b}:682",
            "launches": launches["mask"] + long_path["mask"],
            "check_launches": launches["mask_check"] + blocked["check_launches"]["mask"],
            "max_abs_err": 0.0, **timing("mask")}
    print(json.dumps({"check_kernels": [mask] + [e for e in entries if not e["launches"]]}))
    print(json.dumps({"kernels": [e for e in entries if e["launches"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
