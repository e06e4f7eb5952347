"""A serving cell: `NekoServer` on 127.0.0.1 with the continuous engine
(`continuous_slots`, `continuous_chunk`), as `cli/serve.py
--continuous_slots` builds it, under closed-loop clients in a process of
their own (generators/client.py).

Set-up makes the served weights on the device from the seed, builds the
kernels with one small admission and chunk, starts the server and the
clients, and lets the load warm up; the window is the clients' next
`--seconds`.  Afterwards a sample of the requests finished in the window,
drawn from the seed with the longest among them, is run through the plain
reference: the widest gap by which a served token's reference logit lies
below the reference's best in the generation window (text ids)."""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from portbench import flops, weights
from portbench.generators.closed_loop import Requests
from portbench.reference import model as ref_model
from portbench.trace import Capture, Spans

CLIENT = Path(__file__).resolve().parents[1] / "generators" / "client.py"


def model_config(m: dict):
    from neko_tpu_torch.config import ModelConfig

    return ModelConfig(**m, max_patches=0)


def _wrap(gen, name: str, spans: Spans, calls: list, sync: bool, counts=None):
    """Record the wall time of each call of gen.<name> (an instance
    attribute over the method); with `sync` the device finishes first."""
    inner = getattr(gen, name)

    def call(*a, **kw):
        t0 = time.monotonic()
        with spans(f"serve.{name}"):
            out = inner(*a, **kw)
            if sync:
                torch.cuda.synchronize()
        calls.append((t0, time.monotonic(), counts(a, kw) if counts else None))
        return out

    setattr(gen, name, call)


def _engine_stats(port: int) -> dict:
    """The continuous engine's counters from the server's GET /metrics."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        return json.loads(r.read())["continuous"]


def run(run, config: dict, t: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda") -> None:
    from neko_tpu_torch.convert import build_model
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.serving.server import NekoServer

    m = config["model"]
    slots = t["slots"]
    cfg = model_config(m)
    ts = m["text_tokens"]
    gen = Generator(build_model(cfg, weights.make(m, seed, device, torch.bfloat16, images=False),
                                device), seed=seed % (2 ** 31 - 1))
    # build and load the kernels (#1, #14) before the clock matters
    st = gen.engine_init(2)
    gen.engine_admit(st, [0], {"text": [1, 2, 3]})
    gen.engine_chunk(st, n_steps=2, start=0, end=ts - 1, det=None, temp=None, top_p=None)
    del st
    spans = Spans()
    admits, chunks = [], []
    on_card = device != "cpu"
    _wrap(gen, "engine_admit", spans, admits, trace and on_card,
          lambda a, kw: [len(e["text"]) + 1 for e in a[2]])
    _wrap(gen, "engine_chunk", spans, chunks, False, lambda a, kw: kw["n_steps"])
    server = NekoServer(gen, host="127.0.0.1", port=0, continuous_slots=slots,
                        continuous_chunk=t["chunk"], max_tokens=t["want"]["max"],
                        request_timeout=seconds + t["warm_s"] + t["drain_s"]).start()
    port = server.address[1]
    proc = subprocess.Popen(
        [sys.executable, str(CLIENT), "--port", str(port), "--traffic",
         json.dumps(t), "--seed", str(seed), "--context", str(m["context_len"]),
         "--text_tokens", str(ts), "--seconds", str(seconds)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = json.loads(proc.stdout.readline())
        run.window_start = w0 = first["window_start"]
        w1 = w0 + seconds
        decode_keys = [0, 0]  # valid cached keys attended, decode calls (trace only)
        _sleep_until(w0)
        stats0 = _engine_stats(port)
        cap = None
        if trace:
            _sleep_until(w1 - t["capture_s"])
            restore = _count_decode_keys(decode_keys) if on_card else None
            cap = Capture()
            cap.start()
            _sleep_until(w1)
            cap.stop()
            if restore:
                restore()
        _sleep_until(w1)
        stats1 = _engine_stats(port)
        out, err = proc.communicate(timeout=t["drain_s"] + 120)
        if proc.returncode != 0:
            raise RuntimeError(f"the clients failed ({proc.returncode}): {err[-2000:]}")
        records = json.loads(out.strip().splitlines()[-1])["records"]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.close()
    run.memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.capture = cap.reading(spans) if cap is not None else None
    sent = [r for r in records if w0 <= r[1] < w1]
    done = [r for r in records if r[3] == 200 and r[2] is not None and w0 <= r[2] < w1]
    make = Requests(t, m["context_len"], ts, seed)
    run.attempted = len(sent)
    run.failed = sum(1 for r in sent if r[3] != 200)
    errors = {}
    for r in records:
        if r[3] != 200:
            errors[str(r[4])] = errors.get(str(r[4]), 0) + 1
    for msg, n in sorted(errors.items(), key=lambda kv: -kv[1])[:5]:
        print(f"portbench: {n} request(s) failed: {msg}", file=sys.stderr)
    in_window = lambda c: w0 <= c[0] < w1  # noqa: E731
    run.readings.update({
        "serve": True, "window_s": seconds, "slots": slots, "chunk": t["chunk"],
        "latencies": [(r[2] - r[1]) if r[3] == 200 else float("inf") for r in sent],
        "tokens_done": sum(len(r[4]) for r in done),
        "stats": (stats0, stats1),
        "admit_s": [b - a for a, b, _ in filter(in_window, admits)],
        "chunk_steps": [(b - a, n) for a, b, n in filter(in_window, chunks)],
        "decode_keys": decode_keys,
        "admit_calls_in_capture": [ls for a, b, ls in admits
                                   if cap is not None and cap.host0 <= a < cap.host1],
        "dims": (m["embed_dim"], m["layers"], m["heads"], weights.vocab_sizes(m)[0]),
        "served_flops": sum(_served_flops(m, len(make(r[0])[0]) + 1, len(r[4]))
                            for r in done),
    })
    del gen, server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    run.numbers["served_gap"] = check(m, t, seed, done, make, device)[0]


def _served_flops(m: dict, packed: int, served: int) -> float:
    """The forward FLOPs a request needs: its prompt (and separator)
    prefilled with the head at the last position, then one decode step for
    each served token but the first."""
    D, L = m["embed_dim"], m["layers"]
    V = weights.vocab_sizes(m)[0]
    return (flops.forward_flops(D, L, range(packed), 1, V)
            + flops.forward_flops(D, L, range(packed, packed + served - 1), served - 1, V))


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def _count_decode_keys(acc):
    """While installed, every decode-attention call adds the valid keys of
    its cache mask to a device counter (read after the capture)."""
    from neko_tpu_torch.ops import attention as attn_ops

    orig = attn_ops.decode_attention
    total = torch.zeros((), dtype=torch.int64, device="cuda")

    def counted(q, key, value, start, end, key_mask):
        total.add_(key_mask.sum())
        acc[1] += 1
        return orig(q, key, value, start, end, key_mask)

    attn_ops.decode_attention = counted

    def restore():
        attn_ops.decode_attention = orig
        acc[0] = int(total.item())

    return restore


def sample(done, make, seed: int, n: int):
    """n finished requests drawn from the seed, the longest among them."""
    if not done:
        return []
    longest = max(done, key=lambda r: len(make(r[0])[0]) + len(r[4]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 2 ** 32])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs, make, m: dict, device):
    """(ids, inner positions, positions that predict the served tokens,
    served tokens) of each request: the prompt (inner positions 0..L-1),
    the separator, then the served tokens but the last (no inner
    position), as the engine feeds them."""
    sep = m["text_tokens"] + m["continuous_tokens"] + m["discrete_tokens"]
    for r in reqs:
        ids, _ = make(r[0])
        toks = [int(x) for x in r[4]]
        L = len(ids)
        seq = np.concatenate([ids, [sep], toks[:-1]]).astype(np.int64)
        inner = np.concatenate([np.arange(L), np.full(len(toks), -1)]).astype(np.int64)
        pos = np.arange(L, L + len(toks))
        yield (torch.from_numpy(seq).to(device), torch.from_numpy(inner).to(device),
               torch.from_numpy(pos).to(device), torch.tensor(toks, device=device))


def check(m: dict, t: dict, seed: int, done, make, device, control: bool = False):
    """-> (the widest gap of a served token below the reference's best,
    the same of the control's first tokens, or None)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        W = {n: v.float() for n, v in
             weights.make(m, seed, device, torch.bfloat16, images=False).items()}
        reqs = sample(done, make, seed, t["check_requests"])
        if not reqs:
            return float("inf"), None
        widest, widest_c = 0.0, 0.0
        ts = m["text_tokens"]
        for seq, inner, pos, toks in sequences(reqs, make, m, device):
            ref = ref_model.eval_logits(W, m, seq, inner, pos)[:, :ts]
            best = ref.max(-1).values
            widest = max(widest, float((best - ref.gather(1, toks[:, None])[:, 0]).max()))
            if control:
                c = ref_model.eval_logits(W, m, seq, inner, pos, "fp8")[:, :ts].argmax(-1)
                widest_c = max(widest_c, float((best - ref.gather(1, c[:, None])[:, 0]).max()))
        return widest, (widest_c if control else None)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
