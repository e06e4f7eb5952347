"""Speculative decoding against plain greedy decode in the port (counterpart
of tools/bench_spec.py, which measures neko_tpu):

    python -m neko_tpu_torch.tools.bench_spec [--config medium] [--kv_quant]
        [--k 4] [--gen 128] [--prompt_len 512] [--reps 11] [--steady]
        [--draft_layers N | --draft_path DIR] [--model_path DIR] [--corpus]
        [--device cpu] [--tiny]

For each prompt class it times `Generator.generate_batch` (one token a
decode step, through kernel #14) against `generate_spec` (prompt-lookup
proposals, `--k` a round, verified in one append-mode extend in plain
attention) and reports median tokens/s, the speedup, tokens a round and
rounds:

* `cyclic`: [5, 9] repeated, whose greedy continuation tends to repeat, so
  lookup proposals are accepted (tokens a round near k + 1);
* `random`: random ids on a random-init model, where acceptance is
  incidental (near 1 token a round: the overhead floor);
* `corpus` (`--corpus`): a window of the synthetic text corpus through the
  byte tokenizer (the port has no BPE), in-distribution for a checkpoint
  trained on `--text_datasets synthetic`.

The lossless check (the root harness's check_lossless): the speculative
tokens equal the plain greedy tokens, a first difference allowed only where
the plain run's top-two logits lie within 4 bf16 ulps (a tie flip; counted
in `tie_flips`); a larger gap fails the run (exit 1).  With a draft
(`--draft_layers N`: the target's first N layers, `truncated_draft`;
`--draft_path`: a separately trained checkpoint, `generate_spec_draft`) the
draft scheme is timed and checked the same way.

`--steady` times the loops alone at `--steady_gen` tokens from one shared
prefilled cache (a fresh copy for each call; prefill, packing and
embedding excluded): the plain decode loop (`Generator._decode`), the
lookup verify loop (`_spec_decode`) and, with a draft, the draft loop
(`_spec_draft`).  Prints one JSON line with the root harness's keys and the
card's name and power limit (`card`).  Runs on the card; `--device cpu`
with `--tiny` checks the harness itself.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from neko_tpu_torch.tools import harness

TINY_LIMITS = dict(prompt_len=16, gen=16, steady_gen=24, steady_prompt=16)


def clone_caches(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def timed(fn, reps: int, device, prepare=None):
    """Median seconds of `fn(prepare())` over `reps` calls after one warm-up,
    the device synchronised around each (`prepare` runs outside the clock).
    -> (seconds, the last result)."""
    def call():
        arg = prepare() if prepare else None
        harness.sync(device)
        t0 = time.perf_counter()
        r = fn(arg) if prepare else fn()
        harness.sync(device)
        return time.perf_counter() - t0, r

    call()
    times, r = [], None
    for _ in range(reps):
        dt, r = call()
        times.append(dt)
    return float(np.median(times)), r


def prompts_for(cfg, args, rng):
    out = {"cyclic": {"text": [5, 9] * (args.prompt_len // 2)},
           "random": {"text": [int(t) for t in
                               rng.randint(1, cfg.text_tokens, size=args.prompt_len)]}}
    if args.corpus:
        out["corpus"] = {"text": [int(t) for t in harness.corpus_ids()[:args.prompt_len]]}
    return out


def bench_prompt(gen, draft, prompt, args, start, end, device) -> dict:
    """Plain against lookup speculation (and the draft) on one prompt."""
    (plain,), plain_logits = gen.generate_batch(
        [prompt], max_new_tokens=args.gen, start=start, end=end, return_logits=True)
    plain_s, _ = timed(lambda: gen.generate_batch(
        [prompt], max_new_tokens=args.gen, start=start, end=end, return_logits=False),
        args.reps, device)
    spec_s, (spec, rounds) = timed(lambda: gen.generate_spec(
        prompt, max_new_tokens=args.gen, start=start, end=end, speculate_k=args.k),
        args.reps, device)
    flips, ok, gap = harness.check_lossless(spec, plain, plain_logits[0], start)
    out = {
        "plain_tokens_per_sec": args.gen / plain_s,
        "spec_tokens_per_sec": args.gen / spec_s,
        "speedup": plain_s / spec_s,
        "tokens_per_round": args.gen / rounds,
        "rounds": int(rounds),
        "tie_flips": flips,
        "lossless": bool(ok),
        "tokens_equal": bool(np.array_equal(spec, plain)),
        "first_difference_gap": gap,
    }
    if draft is not None:
        d_s, (dspec, dr) = timed(lambda: gen.generate_spec_draft(
            prompt, draft, max_new_tokens=args.gen, start=start, end=end,
            speculate_k=args.k), args.reps, device)
        d_flips, d_ok, d_gap = harness.check_lossless(dspec, plain, plain_logits[0], start)
        out["draft"] = {"path": args.draft_path, "layers": args.draft_layers,
                        "tokens_per_sec": args.gen / d_s, "speedup": plain_s / d_s,
                        "tokens_per_round": args.gen / dr, "rounds": int(dr),
                        "tie_flips": d_flips, "lossless": bool(d_ok),
                        "tokens_equal": bool(np.array_equal(dspec, plain)),
                        "first_difference_gap": d_gap}
    return out


def steady(gen, draft, prompt_ids, args, start, end, device) -> dict:
    """The loops alone from one prefilled cache (a fresh copy a call)."""
    import torch

    GEN, K = args.steady_gen, args.k
    arrays, lengths = gen._pack([{"text": prompt_ids}])
    pos0, last0, caches0 = gen._prefill(gen.model, arrays, lengths)
    S = gen.cfg.context_len
    hist0 = torch.zeros(1, S + K + 1, dtype=torch.long, device=device)
    hist0[0, :len(prompt_ids)] = torch.as_tensor(arrays["tokens"][0][:len(prompt_ids)])
    rng = torch.Generator(device=device)
    sampling = (1.0, 0, 1.0)

    def dec_loop(c):
        return gen._decode(last0, c, pos0.clone(), pos0.clone(), n_steps=GEN, start=start,
                           end=end, deterministic=True, rng=rng, with_pos=False, ring=False,
                           return_logits=False)[0]

    def spec_loop(c):
        return gen._spec_decode(c, last0, hist0.clone(), pos0.clone(), rng, n_steps=GEN,
                                start=start, end=end, K=K, ngram=2, deterministic=True,
                                sampling=sampling)

    with torch.inference_mode():
        t_dec, dec = timed(dec_loop, args.reps, device, lambda: clone_caches(caches0))
        t_spec, (spec, rounds) = timed(spec_loop, args.reps, device,
                                       lambda: clone_caches(caches0))
    out = {"gen": GEN, "rounds": int(rounds),
           "decode_ms_per_token": t_dec * 1e3 / GEN,
           "spec_ms_per_round": t_spec * 1e3 / rounds,
           "tokens_per_round": GEN / rounds,
           "spec_ms_per_token": t_spec * 1e3 / GEN,
           "steady_speedup": t_dec / t_spec,
           "tokens_equal": bool(np.array_equal(spec[0], dec[0].cpu().numpy()))}
    if draft is not None:
        _, _, caches_d0 = gen._prefill(draft.model, arrays, lengths)

        def draft_loop(cs):
            return gen._spec_draft(draft, cs[0], cs[1], last0, pos0.clone(), rng, n_steps=GEN,
                                   start=start, end=end, K=K, deterministic=True,
                                   sampling=sampling)

        with torch.inference_mode():
            t_draft, (_, dr) = timed(
                draft_loop, args.reps, device,
                lambda: (clone_caches(caches0), clone_caches(caches_d0)))
        out["draft"] = {"rounds": int(dr), "tokens_per_round": GEN / dr,
                        "ms_per_round": t_draft * 1e3 / dr, "ms_per_token": t_draft * 1e3 / GEN,
                        "steady_speedup": t_dec / t_draft}
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    harness.add_model_args(p)
    p.add_argument("--kv_quant", action="store_true")
    p.add_argument("--k", type=int, default=4)
    p.add_argument("--gen", type=int, default=128)
    p.add_argument("--prompt_len", type=int, default=512)
    p.add_argument("--reps", type=int, default=11)
    p.add_argument("--model_path", type=str, default=None,
                   help="restore a trained checkpoint instead of random weights")
    p.add_argument("--draft_layers", type=int, default=0,
                   help="> 0: also time the target's first N layers as the draft")
    p.add_argument("--draft_path", type=str, default=None,
                   help="a separately trained draft checkpoint of the same token space")
    p.add_argument("--corpus", action="store_true",
                   help="add a 'corpus' prompt from the synthetic text corpus")
    p.add_argument("--steady", action="store_true",
                   help="also time the decode loops alone at --steady_gen tokens")
    p.add_argument("--steady_gen", type=int, default=768)
    p.add_argument("--out", type=str, default=None, help="also write the JSON line here")
    return p


def run(args) -> dict:
    device = harness.device_or_exit(args.device, "bench_spec")
    if args.draft_path and args.draft_layers:
        raise SystemExit("bench_spec: --draft_path and --draft_layers are exclusive")
    if args.tiny:
        for k, v in TINY_LIMITS.items():
            if hasattr(args, k):
                setattr(args, k, min(getattr(args, k), v))
    kv = "int8" if args.kv_quant else "native"
    if args.model_path:
        gen = harness.restored_generator(args.model_path, device, kv, args.seed)
    else:
        gen = harness.random_generator(
            harness.model_config(args.config, args.tiny, kv, args.dtype), args.seed, device)
    cfg = gen.cfg
    if args.draft_path:
        draft = harness.restored_generator(args.draft_path, device, kv, args.seed)
        if draft.cfg.vocab_size != cfg.vocab_size:
            raise SystemExit("bench_spec: the draft and the target must share the token space")
    elif args.draft_layers:
        draft = gen.truncated_draft(args.draft_layers)
    else:
        draft = None
    ts = cfg.token_space
    start, end = ts.start("text"), ts.end("text")
    rng = np.random.RandomState(args.seed)
    out = {"config": "tiny" if args.tiny else args.config, "k": args.k, "gen": args.gen,
           "kv_cache": cfg.kv_cache_dtype, "dtype": str(cfg.activation_dtype).replace("torch.", ""),
           "card": harness.card(device)}
    prompts = prompts_for(cfg, args, rng)
    for name, prompt in prompts.items():
        out[name] = bench_prompt(gen, draft, prompt, args, start, end, device)
    if args.steady:
        p_len = TINY_LIMITS["steady_prompt"] if args.tiny else 128
        ids = prompts["corpus"]["text"][:p_len] if args.corpus else [5, 9] * (p_len // 2)
        out["steady"] = steady(gen, draft, ids, args, start, end, device)
    return out


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = run(args)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    lossless = all(v["lossless"] and v.get("draft", {"lossless": True})["lossless"]
                   for v in out.values() if isinstance(v, dict) and "lossless" in v)
    return 0 if lossless else 1


if __name__ == "__main__":
    sys.exit(main())
