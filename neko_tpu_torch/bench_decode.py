"""Batched decode latency and throughput of the port (counterpart of the
root bench_decode.py, which measures neko_tpu):

    python -m neko_tpu_torch.bench_decode [--kv_quant] [--config medium]
        [--runs 10] [--seed 0] [--device cpu] [--tiny]

B = 8 prompts of 512 random text tokens (numpy seed), 64 new tokens through
`Generator.generate_batch` with greedy picks and no logits leaving the
device: one prefill (whole-head attention, kernel #1, once a layer), then 63
decode steps a layer through kernel #14 (its int8 instance with
`--kv_quant`, the int8 KV cache).  The model is the flagship width (768d /
6 layers / 24 heads, k = 1024, bf16, dropout 0; `--config medium`: 1536d /
12 layers / 12 heads) with random weights from `--seed`.

Timing, as the root harness: after a warm-up of both, `--runs` pairs of a
64-token and a 1-token generation, the device synchronised before each
clock reading; prefill_ms is the median 1-token run, per_token_ms the
median 64-token run less it over the 63 decode steps.  Prints one JSON line
with the root harness's keys (metric, config, kv_cache_dtype, batch,
prompt_len, prefill_ms, per_token_ms, decode_tokens_per_sec), the card's
name and power limit (`card`), and `launches`: the #1 and #14 calls of one
timed 64-token generation.  Runs on the card; `--device cpu` (with
`--tiny`: a 32d / 2-layer model at k = 64 in fp32, 16-token prompts, 8 new
tokens) checks the harness itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from neko_tpu_torch.tools import harness

B, P_LEN, GEN = 8, 512, 64
TINY_SHAPE = dict(prompt_len=16, new=8)


def build(config: str = "flagship", kv: str = "native", device="cuda", seed: int = 0,
          tiny: bool = False, dtype=None):
    """-> (Generator over random weights from `seed`, the B prompts)."""
    cfg = harness.model_config(config, tiny, kv, dtype)
    gen = harness.random_generator(cfg, seed, device)
    p_len = TINY_SHAPE["prompt_len"] if tiny else P_LEN
    rng = np.random.RandomState(seed)
    examples = [{"text": list(rng.randint(1, cfg.text_tokens, size=p_len))} for _ in range(B)]
    return gen, examples


def measure(gen, examples, new: int = GEN, runs: int = 10, **generate_kw) -> dict:
    """The timing loop: a warm-up of a `new`-token and a 1-token generation,
    then `runs` pairs of them, the device synchronised before each clock
    reading.  `generate_kw` goes to generate_batch (by default the text
    range, greedy, no logits).  -> {"prefill_ms", "per_token_ms" (median
    full run less the median 1-token run, over new - 1 steps), "tokens"
    [B, new] of the first timed run, "launches" of #1 and #14 in it}."""
    ts = gen.cfg.token_space
    kw = dict(start=ts.start("text"), end=ts.end("text"), return_logits=False)
    kw.update(generate_kw)
    dev = gen.device

    def run(n):
        (toks,) = gen.generate_batch(examples, max_new_tokens=n, **kw)
        harness.sync(dev)
        return toks

    run(new)
    run(1)
    full, one, tokens, launches = [], [], None, None
    for i in range(runs):
        before = harness.read_launches()
        harness.sync(dev)
        t0 = time.perf_counter()
        toks = run(new)
        full.append(time.perf_counter() - t0)
        if i == 0:
            tokens, launches = toks, harness.launches_since(before)
        t0 = time.perf_counter()
        run(1)
        one.append(time.perf_counter() - t0)
    prefill = float(np.median(one))
    per_token = (float(np.median(full)) - prefill) / (new - 1)
    return {"prefill_ms": prefill * 1e3, "per_token_ms": per_token * 1e3,
            "tokens": tokens, "launches": launches}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    harness.add_model_args(p)
    p.add_argument("--kv_quant", action="store_true",
                   help="serve from the int8 KV cache (kernel #14's int8 instance)")
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--out", type=str, default=None, help="also write the JSON line here")
    args = p.parse_args(argv)
    device = harness.device_or_exit(args.device, "bench_decode")
    kv = "int8" if args.kv_quant else "native"
    gen, examples = build(args.config, kv, device, args.seed, args.tiny, args.dtype)
    new = TINY_SHAPE["new"] if args.tiny else GEN
    m = measure(gen, examples, new, args.runs)
    cfg = gen.cfg
    out = {
        "metric": "batched_decode",
        "config": "tiny" if args.tiny else f"{cfg.embed_dim}d{cfg.layers}L",
        "kv_cache_dtype": kv,
        "batch": len(examples),
        "prompt_len": len(examples[0]["text"]),
        "new_tokens": new,
        "prefill_ms": m["prefill_ms"],
        "per_token_ms": m["per_token_ms"],
        "decode_tokens_per_sec": len(examples) * 1e3 / m["per_token_ms"],
        "dtype": str(cfg.activation_dtype).replace("torch.", ""),
        "card": harness.card(device),
        "launches": m["launches"],
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
