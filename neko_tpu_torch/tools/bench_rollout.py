"""Control evaluation wall time in the port: the rollout cache against
re-packing (counterpart of tools/bench_rollout.py, which measures neko_tpu):

    python -m neko_tpu_torch.tools.bench_rollout [--iterations 2]
        [--horizon 64] [--promptless] [--seed 0] [--device cpu] [--tiny]

`ControlTask.evaluate` on `neko-synth-continuous-v0` (8 episodes of
`--horizon` steps, 8 observation and 2 action dimensions) at the flagship
width (768d / 6 layers / 24 heads, k = 1024, bf16, random weights from
`--seed`) with a full-context prompt (none with `--promptless`), so every
env step slides the window:

* `rollout_cache=True`: `RolloutSession` keeps the KV cache across env
  steps; a step ring-extends it with the new [obs | sep] tokens (plain
  attention, as neko_tpu's XLA extend) and decodes the action tokens
  through kernel #14;
* `rollout_cache=False`: every step re-packs the trimmed window and
  re-prefills it through kernel #1, then decodes the actions through #14.

Each mode runs a warm-up of `--warmup` episodes, then `--iterations`
timed episodes from the same env seed and the same evaluation prompts (the
task's prompt stream is rewound before each run).  The actions every env
step took are recorded: `actions_equal` says whether both modes took the
same actions, `actions_agree_share` the share of env steps (in order, up
to the shorter run) whose actions agree, `first_difference_step` the first
that does not.  They differ by design once the ring has evicted a
timestep: the cached tokens keep the hidden states they were computed with
over their own earlier window, where a re-pack recomputes them over the
trimmed one (neko_tpu/inference/generator.py:2034-2040, "TransformerXL-style
inference memory"); until the first eviction (`--promptless` with a horizon
under the window's timesteps) the two take the same actions.  Prints one
JSON line with the root harness's keys (repack_ms_per_env_step,
rollout_cache_ms_per_env_step, speedup) and the card's name and power
limit (`card`).  Runs on the card; `--device cpu` with `--tiny` (32d /
2 layers at k = 64, fp32) checks the harness itself.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np

from neko_tpu_torch.tools import harness

ENV = "neko-synth-continuous-v0"


def setup(args):
    """-> (Generator, ControlTask, env) on `args.device`."""
    from neko_tpu_torch.envs.setup_env import load_env_dataset
    from neko_tpu_torch.tasks.control import ControlTask

    device = harness.device_or_exit(args.device, "bench_rollout")
    cfg = harness.model_config("flagship", args.tiny, "native", args.dtype)
    env, ds = load_env_dataset(ENV, {"n_episodes": 8, "horizon": args.horizon})
    task = ControlTask("synth", env, ds, context_len=cfg.context_len, seed=args.seed)
    return harness.random_generator(cfg, args.seed, device), task, env


def run_mode(gen, task, env, rollout_cache: bool, iterations: int, promptless: bool,
             eval_rng_state):
    """`iterations` episodes of task.evaluate from env seed 11 and the given
    prompt stream.  -> (seconds, the actions of every env step)."""
    actions = []
    step = env.step

    def recording_step(action):
        actions.append(np.array(action, copy=True))
        return step(action)

    env.reset(seed=11)
    task.eval_rng = copy.deepcopy(eval_rng_state)
    env.step = recording_step
    try:
        harness.sync(gen.device)
        t0 = time.perf_counter()
        task.evaluate(gen, n_iterations=iterations, deterministic=True,
                      promptless_eval=promptless, rollout_cache=rollout_cache)
        harness.sync(gen.device)
        seconds = time.perf_counter() - t0
    finally:
        env.step = step
    return seconds, actions


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    harness.add_model_args(p, config=False)
    p.add_argument("--iterations", type=int, default=2, help="timed episodes a mode")
    p.add_argument("--warmup", type=int, default=1, help="untimed episodes a mode first")
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--promptless", action="store_true",
                   help="no expert prompt: the window fills from the episode alone")
    p.add_argument("--out", type=str, default=None, help="also write the JSON line here")
    return p


def run(args) -> dict:
    gen, task, env = setup(args)
    rng_state = copy.deepcopy(task.eval_rng)
    for cached in (True, False):
        if args.warmup:
            run_mode(gen, task, env, cached, args.warmup, args.promptless, rng_state)
    before = harness.read_launches()
    t_cached, a_cached = run_mode(gen, task, env, True, args.iterations, args.promptless,
                                  rng_state)
    cached_launches = harness.launches_since(before)
    before = harness.read_launches()
    t_repack, a_repack = run_mode(gen, task, env, False, args.iterations, args.promptless,
                                  rng_state)
    repack_launches = harness.launches_since(before)
    n = min(len(a_cached), len(a_repack))
    agree = [bool(np.array_equal(a_cached[i], a_repack[i])) for i in range(n)]
    cfg = gen.cfg
    ctx_ts = cfg.context_len // task.tokens_per_timestep
    return {
        "metric": "control_eval_wall_time",
        "config": (f"{'tiny' if args.tiny else f'{cfg.embed_dim}d/{cfg.layers}L'} "
                   f"k={cfg.context_len}, {'no' if args.promptless else 'full-context'} "
                   f"prompt, {args.iterations} episodes x {args.horizon} steps"),
        "repack_ms_per_env_step": 1e3 * t_repack / max(len(a_repack), 1),
        "rollout_cache_ms_per_env_step": 1e3 * t_cached / max(len(a_cached), 1),
        "speedup": t_repack / t_cached,
        "env_steps": [len(a_cached), len(a_repack)],
        "window_timesteps": ctx_ts,
        "actions_equal": len(a_cached) == len(a_repack) and all(agree),
        "actions_agree_share": float(np.mean(agree)) if agree else 1.0,
        "first_difference_step": agree.index(False) if not all(agree) else None,
        "actions_finite": bool(all(np.isfinite(a).all() for a in a_cached + a_repack)),
        "launches": {"rollout_cache": cached_launches, "repack": repack_launches},
        "dtype": str(cfg.activation_dtype).replace("torch.", ""),
        "card": harness.card(gen.device),
    }


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = run(args)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if out["actions_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
