"""Serving throughput and latency of the port: the coalescing worker against
continuous batching (counterpart of tools/bench_serving.py, which measures
neko_tpu):

    python -m neko_tpu_torch.tools.bench_serving [--config medium]
        [--clients 8] [--requests 32] [--max_new 32] [--prompt_len 256]
        [--slots 8] [--chunk 8] [--rounds 1] [--spec_k K [--spec_threshold T]]
        [--mixed] [--corpus] [--model_path DIR] [--device cpu] [--tiny]

The in-process HTTP server (`serving.server.NekoServer` on 127.0.0.1) serves
one Generator in each mode: `coalesce` (the micro-batch coalescing worker,
`max_batch = --slots`), `continuous` (`continuous_slots`,
`continuous_chunk`), and with `--spec_k` also `continuous_spec_always`
(every chunk a prompt-lookup verify round) and `continuous_spec` (the
adaptive engine, verify rounds while a row wants `--spec_threshold` more
tokens).  Each mode gets the same closed-loop load (`run_load`: each of
`--clients` threads posts its next request as soon as its previous one is
answered) of one seeded workload (`RandomState(0)`): `--requests` greedy
requests of `prompt_len // 2`..`prompt_len` random text ids wanting
`max_new // 2`..`max_new` tokens (`--mixed`: every other request a short
burst of `max_new // 16`..`max_new // 8`; `--corpus`: windows of the
synthetic text corpus through the byte tokenizer, the port having no BPE).
A warm-up pass over the whole workload, then `--rounds` timed passes; the
pass of median wall time is reported.

Greedy outputs must not depend on the scheduling: `outputs_equal` says
whether every mode gave every request the same tokens.  Where they differ,
each mode's tokens are held against the request's greedy tokens alone
(`generate_batch` of one row) by the rule of bench_spec (a first difference
only at a top-two logit gap within 4 bf16 ulps): `lossless`, `tie_flips`.
Prints one JSON line with the root harness's keys (per mode
requests_per_sec, gen_tokens_per_sec, p50/p95/p99_latency_s, errors,
wall_s) and `card`; exits 1 on an error or a difference beyond a tie.
`--tiny` shrinks the model and the load (16-token prompts, 8 new tokens);
the device stays `--device`'s (the card unless `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time
import urllib.request

import numpy as np

from neko_tpu_torch.tools import harness


def post(url: str, payload: dict, stream: bool = False, timeout: float = 600.0):
    """One /v1/generate request at `url` (streamed: chunked NDJSON, the
    done event's body kept).  -> (reply body, seconds to the first tokens
    event, or None unstreamed)."""
    body = dict(payload, stream=True) if stream else payload
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    t0, first, done = time.perf_counter(), None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if not stream:
            return json.loads(r.read()), None
        for line in r:
            ev = json.loads(line)
            if "error" in ev:
                raise RuntimeError(f"stream error: {ev['error']}")
            if ev.get("done"):
                done = ev
            elif first is None:
                first = time.perf_counter() - t0
    if done is None:
        raise RuntimeError("the stream ended without a done event")
    return done, first


def run_load(url: str, jobs, clients: int, stream: bool = False, timeout: float = 600.0):
    """Closed loop: `clients` threads drain `jobs` (payloads of
    /v1/generate at `url`), each posting its next job when its previous one
    is answered.  -> the summary (wall_s, requests_per_sec,
    gen_tokens_per_sec, p50/p95/p99_latency_s, errors) and, per job in
    order, "replies" (None where it failed), "latency_s" and, streamed,
    "ttft_s" (seconds to the first tokens event)."""
    lock = threading.Lock()
    it = iter(enumerate(jobs))
    n = len(jobs)
    replies, lat, ttft = [None] * n, [None] * n, [None] * n
    errors = []

    def worker():
        while True:
            with lock:
                i, job = next(it, (None, None))
            if job is None:
                return
            t0 = time.perf_counter()
            try:
                reply, first = post(url + "/v1/generate", job, stream, timeout)
                reply["tokens"]  # noqa: B018 -- a reply without tokens is an error
            except Exception as e:  # noqa: BLE001 -- counted as the harness's errors
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                continue
            replies[i], lat[i], ttft[i] = reply, time.perf_counter() - t0, first

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    done = sorted(x for x in lat if x is not None)
    tokens = sum(len(r["tokens"]) for r in replies if r is not None)
    return {
        "wall_s": wall,
        "requests_per_sec": len(done) / wall,
        "gen_tokens_per_sec": tokens / wall,
        "p50_latency_s": statistics.median(done) if done else None,
        "p95_latency_s": done[int(0.95 * (len(done) - 1))] if done else None,
        "p99_latency_s": done[int(0.99 * (len(done) - 1))] if done else None,
        "errors": len(errors),
        "error_messages": errors[:4],
        "replies": replies, "latency_s": lat, "ttft_s": ttft,
    }


def workload(args, cfg) -> list:
    """The seeded jobs every mode gets (RandomState(0), as the root harness)."""
    rng = np.random.RandomState(0)
    ids = np.asarray(harness.corpus_ids()) if args.corpus else None
    jobs = []
    for i in range(args.requests):
        L = int(rng.randint(args.prompt_len // 2, args.prompt_len + 1))
        if ids is not None:
            o = int(rng.randint(0, max(1, len(ids) - L)))
            text = [int(t) for t in ids[o:o + L]]
        else:
            text = [int(t) for t in rng.randint(1, cfg.text_tokens, L)]
        if args.mixed and i % 2 == 1:
            want = int(rng.randint(max(1, args.max_new // 16), max(2, args.max_new // 8) + 1))
        else:
            want = int(rng.randint(max(1, args.max_new // 2), args.max_new + 1))
        jobs.append({"text": text, "max_new_tokens": want})
    return jobs


def modes(args):
    out = [("coalesce", dict(max_batch=args.slots)),
           ("continuous", dict(continuous_slots=args.slots, continuous_chunk=args.chunk))]
    if args.spec_k > 0:
        out.append(("continuous_spec_always", dict(
            continuous_slots=args.slots, continuous_chunk=args.chunk,
            continuous_spec_k=args.spec_k, continuous_spec_threshold=0)))
        out.append(("continuous_spec", dict(
            continuous_slots=args.slots, continuous_chunk=args.chunk,
            continuous_spec_k=args.spec_k, continuous_spec_threshold=args.spec_threshold)))
    return out


def compare_outputs(gen, jobs, tokens_by_mode) -> dict:
    """outputs_equal across modes; where a request's modes differ, each
    mode's tokens against the request alone by check_lossless."""
    names = list(tokens_by_mode)
    base = tokens_by_mode[names[0]]
    differing = [i for i in range(len(jobs))
                 if any(tokens_by_mode[m][i] != base[i] for m in names[1:])]
    flips, lossless = 0, True
    ts = gen.cfg.token_space
    start, end = ts.start("text"), ts.end("text")
    for i in differing:
        (want,), logits = gen.generate_batch(
            [{"text": jobs[i]["text"]}], max_new_tokens=jobs[i]["max_new_tokens"], start=start,
            end=end, return_logits=True)
        for m in names:
            f, ok, _ = harness.check_lossless(tokens_by_mode[m][i], want, logits[0], start)
            flips += f
            lossless = lossless and ok
    return {"outputs_equal": not differing, "requests_differing": len(differing),
            "tie_flips": flips, "lossless": lossless}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    harness.add_model_args(p)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--max_new", type=int, default=32)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--chunk", type=int, default=8)
    p.add_argument("--prompt_len", type=int, default=256)
    p.add_argument("--rounds", type=int, default=1,
                   help="timed passes a mode; the pass of median wall time is reported")
    p.add_argument("--model_path", type=str, default=None,
                   help="serve a trained checkpoint instead of random weights")
    p.add_argument("--corpus", action="store_true",
                   help="prompts from the synthetic text corpus instead of random ids")
    p.add_argument("--spec_k", type=int, default=0,
                   help="> 0: also the engine with prompt-lookup verify rounds of K")
    p.add_argument("--spec_threshold", type=int, default=48)
    p.add_argument("--mixed", action="store_true",
                   help="every other request a short burst (max_new // 16..max_new // 8)")
    p.add_argument("--out", type=str, default=None, help="also write the JSON line here")
    return p


def run(args) -> dict:
    from neko_tpu_torch.serving.server import NekoServer

    device = harness.device_or_exit(args.device, "bench_serving")
    if args.tiny:
        args.prompt_len = min(args.prompt_len, 16)
        args.max_new = min(args.max_new, 8)
    if args.model_path:
        gen = harness.restored_generator(args.model_path, device, seed=args.seed)
    else:
        gen = harness.random_generator(
            harness.model_config(args.config, args.tiny, dtype=args.dtype), args.seed, device)
    jobs = workload(args, gen.cfg)
    out = {"config": "tiny" if args.tiny else args.config, "model_path": args.model_path,
           "corpus": args.corpus, "clients": args.clients, "requests": args.requests,
           "slots": args.slots, "chunk": args.chunk, "spec_k": args.spec_k,
           "mixed": args.mixed, "spec_threshold": args.spec_threshold,
           "dtype": str(gen.cfg.activation_dtype).replace("torch.", ""),
           "card": harness.card(device)}
    tokens_by_mode = {}
    for mode, kwargs in modes(args):
        with NekoServer(gen, port=0, request_timeout=600.0, **kwargs) as srv:
            url = f"http://{srv.address[0]}:{srv.address[1]}"
            run_load(url, jobs, args.clients)  # warm-up: every batch shape once
            passes = [run_load(url, jobs, args.clients) for _ in range(args.rounds)]
        passes.sort(key=lambda r: r["wall_s"])
        pick = passes[len(passes) // 2]
        tokens_by_mode[mode] = [r["tokens"] if r else None for r in pick["replies"]]
        out[mode] = {k: v for k, v in pick.items()
                     if k not in ("replies", "latency_s", "ttft_s")}
    out["speedup_tokens"] = (out["continuous"]["gen_tokens_per_sec"]
                             / max(out["coalesce"]["gen_tokens_per_sec"], 1e-9))
    if args.spec_k > 0:
        spec, always = out["continuous_spec"], out["continuous_spec_always"]
        out["spec_over_continuous"] = (spec["gen_tokens_per_sec"]
                                       / max(out["continuous"]["gen_tokens_per_sec"], 1e-9))
        out["adaptive_over_always_spec"] = (spec["gen_tokens_per_sec"]
                                            / max(always["gen_tokens_per_sec"], 1e-9))
        best = max(out["continuous"]["gen_tokens_per_sec"], always["gen_tokens_per_sec"])
        out["adaptive_over_best_pure"] = spec["gen_tokens_per_sec"] / max(best, 1e-9)
    out["errors"] = sum(out[m]["errors"] for m in tokens_by_mode)
    if out["errors"] == 0:
        out.update(compare_outputs(gen, jobs, tokens_by_mode))
    else:
        out.update(outputs_equal=False, lossless=False)
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = run(args)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if out["errors"] == 0 and out["lossless"] else 1


if __name__ == "__main__":
    sys.exit(main())
