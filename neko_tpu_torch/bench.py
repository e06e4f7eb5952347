"""Train-step benchmark of the port on one CUDA device:

    python -m neko_tpu_torch.bench [--config flagship|medium|long|long4k] [--steps N]
    python -m neko_tpu_torch.bench --profile   # where a step's time goes
    python -m neko_tpu_torch.bench --config long4k --mesh_seq_axis 4   # a ring step
    python -m neko_tpu_torch.bench --fused_adamw   # the optimizer as kernel #16

The counterpart of the root bench.py's device-step measurement: the
jit-free eager train step (`TrainContext.train_step`) on the flagship mixed
text / continuous / image batch, with the root bench's exact patch pool and
loss-target budgets (JAX-free copies of its `build_examples`,
`patch_budget`, `tgt_budget` and `train_flops_per_token` live here; the root
bench.py is not imported).  Weights are random, from `--seed`.

Prints one JSON line: metric (named by `metric_name`, the root bench's
rule), value (tokens/s of the device step on one resident batch), unit,
end_to_end (tokens/s when every step's batch is packed afresh and copied to
the device by the port's `HostPrefetcher`, as the Trainer feeds its steps:
the root bench's measurement, 5 warm-up steps and then the best of 3
windows of 40 steps), e2e_over_device_step (their ratio), vs_baseline
(value over the root bench's REFERENCE_TOKENS_PER_SEC_PER_CHIP), mfu (against the
dense bf16 peak of the card, keyed by its name), flops_per_token (MFLOPs),
step_ms, peak_mem_gb, and the card's name and power limit as nvidia-smi
reports them; `--profile` adds `profile_ms_per_step` (device time by part)
and `optimizer_alone_ms` (the optimizer half timed alone, CUDA events).  No
CUDA device: it exits with an error, never a CPU number.

`long` (k = 2048) and `long4k` (k = 4096) are the root bench's long-context
configurations and train through the blocked attention kernels.
`--mesh_seq_axis N` (the JAX package's flag) runs the step under a mesh with
N sequence shards on the one device, so every layer's attention is ring
attention over them (ops/ring_kernel.py); `--profile` then counts the ring
kernels as attention and the torch passes between them as "ring merge".  `setup`
and `model_config` also take a shape dict of the CONFIGS form, for a
configuration the root bench does not have (chip_smoke.py's k = 8192 step).
`--fused_adamw` (the JAX train CLI's flag) runs the optimizer half as
`FusedAdamW`: the global norm and one launch of the fused AdamW kernel,
in place of the clip pass and torch's AdamW.

The root bench's measured-reference keys are not printed: their JSON files
describe other hardware.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np

# the root bench's `vs_baseline` denominator (bench.py:41), tokens/s per chip
REFERENCE_TOKENS_PER_SEC_PER_CHIP = 25_000.0

# dense bf16 tensor-core peak FLOP/s by torch.cuda.get_device_name
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,   # H100 SXM (NVIDIA data sheet)
}

CONFIGS = {
    "flagship": dict(embed_dim=768, layers=6, heads=24, batch_per_chip=16),
    "medium": dict(embed_dim=1536, layers=12, heads=12, batch_per_chip=8),
    "long": dict(embed_dim=768, layers=6, heads=24, batch_per_chip=8, context_len=2048),
    "long4k": dict(embed_dim=768, layers=6, heads=24, batch_per_chip=4, context_len=4096),
}


def metric_name(cfg) -> str:
    """The root bench's metric name (bench.py:274-278): width and depth, and
    the context length when it is not 1024."""
    label = f"{cfg.embed_dim}d{cfg.layers}L"
    if cfg.context_len != 1024:
        label += f"_k{cfg.context_len}"
    return f"multimodal_train_tokens_per_sec_per_chip_{label}"


def train_flops_per_token(cfg, target_fraction: float) -> float:
    """PaLM-convention training FLOPs per token (no causal discount):
    6 x matmul params touched per token + 12*L*D*S attention score/value
    FLOPs.  The vocab head counts only at target positions (gathered CE)."""
    D, L, S = cfg.embed_dim, cfg.layers, cfg.context_len
    body_params = L * 12 * D * D          # qkv(3D^2) + proj(D^2) + mlp(8D^2)
    head_params = D * cfg.padded_vocab_size * target_fraction
    return 6.0 * (body_params + head_params) + 12.0 * L * D * S


def tgt_budget(batch_size, cfg) -> int:
    """Loss-target budget of the bench mixture (mirrors build_examples)."""
    ctx_ts_cont = cfg.context_len // (8 + 2 + 1)
    ctx_ts_img = cfg.context_len // 38
    n_img = sum(1 for i in range(batch_size) if i % 3 == 2)
    n_txt = sum(1 for i in range(batch_size) if i % 3 == 0)
    n_cont = batch_size - n_img - n_txt
    t = (
        n_txt * (cfg.context_len - 1)
        + n_cont * ctx_ts_cont * 2
        + n_img * ctx_ts_img * 1
    )
    return -(-t // 256) * 256


def build_examples(cfg, batch_size, seed=0):
    """Raw mixed-modality example dicts (text / MuJoCo-like / Atari-like)."""
    rng = np.random.RandomState(seed)
    ts = cfg.token_space
    examples = []
    ctx_ts_cont = cfg.context_len // (8 + 2 + 1)
    # image env: 96x96 -> 36 patches/ts (Atari-after-pad geometry), 38 tok/ts
    ctx_ts_img = cfg.context_len // 38
    for i in range(batch_size):
        k = i % 3
        if k == 0:  # text: full-context sequence
            examples.append(
                {"text": list(rng.randint(1, ts.text_tokens, size=cfg.context_len - 1))}
            )
        elif k == 1:  # MuJoCo-like continuous
            T = ctx_ts_cont
            examples.append(
                {
                    "continuous_obs": rng.randn(T, 8).astype(np.float32),
                    "continuous_actions": np.tanh(rng.randn(T, 2)).astype(np.float32),
                }
            )
        else:  # Atari-like image + discrete
            T = ctx_ts_img
            examples.append(
                {
                    "images": rng.randint(0, 255, (T, 96, 96, 3)).astype(np.uint8),
                    "discrete_actions": rng.randint(0, 18, size=T).astype(np.int32),
                }
            )
    return examples


def patch_budget(cfg, batch_size):
    ctx_ts_img = cfg.context_len // 38
    n_img = sum(1 for i in range(batch_size) if i % 3 == 2)
    return -(-(n_img * ctx_ts_img * 36) // 256) * 256


def model_config(name):
    """The bench's ModelConfig for a CONFIGS name or a shape dict of that
    form."""
    from neko_tpu_torch.config import ModelConfig

    shape = CONFIGS[name] if isinstance(name, str) else name
    context_len = shape.get("context_len", 1024)
    return ModelConfig(
        embed_dim=shape["embed_dim"], layers=shape["layers"], heads=shape["heads"],
        dropout=0.1, context_len=context_len,
        max_patches=(context_len // 38) * 36, dtype="bfloat16",
    )


def setup(name="flagship", device="cuda", seed: int = 0, mesh_seq_axis: int = 1,
          fused_adamw: bool = False):
    """-> (cfg, TrainContext, TrainState, batch on `device`, batch size) for
    a CONFIGS name or a shape dict.  The optimizer settings are the root
    bench's, with `fused_adamw` as given.  `mesh_seq_axis` > 1: the steps run
    under a mesh with that many sequence shards on the device."""
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.data.packing import SequencePacker
    from neko_tpu_torch.parallel.mesh import create_mesh
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg = model_config(name)
    batch_size = (CONFIGS[name] if isinstance(name, str) else name)["batch_per_chip"]
    opt = OptimizerConfig(learning_rate=1e-4, init_lr=1e-7, warmup_steps=100,
                          training_steps=10_000, fused_adamw=fused_adamw)
    mesh = create_mesh(data=1, seq=mesh_seq_axis) if mesh_seq_axis > 1 else None
    ctx = TrainContext(cfg, opt, device=device, seed=seed, mesh=mesh)
    arrays = SequencePacker(cfg).pack_batch(
        build_examples(cfg, batch_size, seed),
        patch_budget=patch_budget(cfg, batch_size),
        target_budget=tgt_budget(batch_size, cfg),
    )
    arrays.pop("lengths")
    return cfg, ctx, ctx.init_state(), to_device_batch(arrays, device), batch_size


def card() -> str:
    """'name, power limit' of device 0 as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_steps(ctx, state, batch, n: int):
    """n train steps between two synchronizations.  -> (seconds, losses)."""
    _sync(ctx.device)
    t0 = time.perf_counter()
    losses = [ctx.train_step(state, batch)[1] for _ in range(n)]
    _sync(ctx.device)
    return time.perf_counter() - t0, [float(x) for x in losses]


def end_to_end(ctx, state, cfg, batch_size: int, seed: int = 0, steps: int = 40,
               windows: int = 3, warmup: int = 5) -> float:
    """Tokens/s of train steps whose batches are packed afresh (from one of
    four example pools, in turn) and copied to the device by a
    `HostPrefetcher` thread, as the Trainer feeds its steps (the root
    bench's end_to_end): `warmup` steps, then the best of `windows` windows
    of `steps` steps."""
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.data.packing import SequencePacker
    from neko_tpu_torch.data.pipeline import HostPrefetcher

    packer = SequencePacker(cfg)
    pools = [build_examples(cfg, batch_size, seed=s) for s in range(seed, seed + 4)]
    turn = itertools.count()
    budgets = dict(patch_budget=patch_budget(cfg, batch_size),
                   target_budget=tgt_budget(batch_size, cfg))

    def produce():
        arrays = packer.pack_batch(pools[next(turn) % len(pools)], **budgets)
        arrays.pop("lengths")
        return to_device_batch(arrays, ctx.device, non_blocking=True)

    pf = HostPrefetcher(produce, depth=2, device=ctx.device)
    try:
        for _ in range(warmup):
            ctx.train_step(state, pf.get())
        best = float("inf")
        for _ in range(windows):
            _sync(ctx.device)
            t0 = time.perf_counter()
            for _ in range(steps):
                ctx.train_step(state, pf.get())
            _sync(ctx.device)
            best = min(best, time.perf_counter() - t0)
    finally:
        pf.close()
    return batch_size * cfg.context_len * steps / best


def measure(ctx, state, batch, cfg, batch_size: int, steps: int = 10, warmup: int = 3,
            seed: int = 0, e2e: dict = None) -> dict:
    """The device step on one resident batch, then `end_to_end` (`e2e`: its
    keyword arguments).  -> {"tokens_per_sec", "step_ms", "end_to_end"
    (tokens/s), "e2e_over_device_step"}."""
    time_steps(ctx, state, batch, warmup)
    dt, losses = time_steps(ctx, state, batch, steps)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite loss: {losses}")
    tokens_per_sec = batch_size * cfg.context_len * steps / dt
    e2e_tps = end_to_end(ctx, state, cfg, batch_size, seed, **(e2e or {}))
    return {"tokens_per_sec": tokens_per_sec, "step_ms": dt * 1e3 / steps,
            "end_to_end": e2e_tps, "e2e_over_device_step": e2e_tps / tokens_per_sec}


def optimizer_ms(ctx, state, batch, steps: int = 3) -> float:
    """Device ms of the optimizer half of a step alone (clip + AdamW, or
    FusedAdamW's norm + kernel), from
    CUDA events around `apply_gradients` after the gradients are ready: the
    check on the profile's "optimizer" part."""
    import torch

    total = 0.0
    for _ in range(steps):
        ctx.loss_and_grads(state, batch)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        ctx.apply_gradients(state)
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / steps


def profile_breakdown(ctx, state, batch, cfg, steps: int = 3) -> dict:
    """Device time of `steps` train steps by part, from torch.profiler: our
    attention kernels (device rows of csrc/attention_fwd.cuh's and
    attention_bwd.cuh's kernels, by name: whole-head, blocked and ring), the
    ring's merge passes (device rows inside the device-side spans of
    ring_kernel.MERGE_RANGE; 0 off a 'seq' mesh), the optimizer (device
    rows inside the device-side spans of the step's "optimizer" range and
    of AdamW's own; the step runs on one stream), the head and loss (the
    device rows of the loss head kernel #15, csrc/fused_logz_tl.cu, by name,
    and aten ops outside that range with a vocab-wide operand; CUDA runtime rows
    such as "Command Buffer Full" can carry the device time of kernels
    launched during them, so only ops with shapes count), the MLP (a
    4D-wide operand) and the
    rest of the device time; plus the idle share of the window and the
    twelve kernels that take the most device time.  Raises when the parts
    add up to more than the device time, or the device time to more than
    the wall time: then something was counted twice.
    -> {part: ms per step, "wall_ms": ms per step, "idle_share": x,
        "top_kernels_ms": {kernel name: ms per step}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neko_tpu_torch.ops.ring_kernel import MERGE_RANGE

    def ours(name: str) -> bool:
        return "attention_fwd_kernel" in name or "attention_bwd_" in name

    def loss_head(name: str) -> bool:
        return "fused_logz_tl" in name

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ctx.train_step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # kernels, copies and sets.  An annotated range has a device-side row
    # spanning its kernels, which the profiler also files as a kernel of the
    # range's CPU row: a span, not device time.
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    # the device-side span of a range leaves out its nested ranges' kernels:
    # AdamW's step is its own range ("Optimizer.step#AdamW.step"); FusedAdamW
    # launches every kernel inside its own, so "optimizer" has no span then
    opt_spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA and e.is_user_annotation
                 and (e.name == "optimizer" or e.name.startswith("Optimizer.step#"))]
    if len(opt_spans) != (1 if ctx.opt_cfg.fused_adamw else 2) * steps:
        raise RuntimeError(f"{len(opt_spans)} device-side optimizer ranges in {steps} steps")
    merge_spans = [(e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA and e.is_user_annotation
                   and e.name == MERGE_RANGE]
    busy = sum(e.self_device_time_total for e in device)
    parts = {"attention kernels": 0.0, "ring merge": 0.0, "head + loss": 0.0, "MLP": 0.0,
             "optimizer": 0.0}
    for e in device:
        if ours(e.name):
            parts["attention kernels"] += e.self_device_time_total
        elif loss_head(e.name):
            parts["head + loss"] += e.self_device_time_total
        elif any(a <= e.time_range.start < b for a, b in opt_spans):
            parts["optimizer"] += e.self_device_time_total
        elif any(a <= e.time_range.start < b for a, b in merge_spans):
            parts["ring merge"] += e.self_device_time_total
    V, F4 = cfg.padded_vocab_size, 4 * cfg.embed_dim
    for evt in events:
        # a CPU op's self device time is that of the kernels it launched
        if (evt.device_type != DeviceType.CPU or evt.is_user_annotation
                or evt.self_device_time_total <= 0
                or any(ours(k.name) or loss_head(k.name) for k in evt.kernels)):
            continue
        node = evt
        while node is not None and node.name not in ("optimizer", MERGE_RANGE):
            node = node.cpu_parent
        if node is not None:
            continue  # counted from the device rows above
        dims = {d for shape in (evt.input_shapes or []) for d in (shape or [])}
        part = "head + loss" if V in dims else "MLP" if F4 in dims else None
        if part:
            parts[part] += evt.self_device_time_total
    parts["other"] = busy - sum(parts.values())
    if parts["other"] < 0 or busy > wall:
        raise RuntimeError(f"profile counts device time twice: parts {parts}, "
                           f"device busy {busy} us, wall {wall} us")
    out = {k: v / 1e3 / steps for k, v in parts.items()}
    out["wall_ms"] = wall / 1e3 / steps
    out["idle_share"] = 1.0 - busy / wall
    by_kernel = {}
    for e in device:
        by_kernel[e.name[:80]] = by_kernel.get(e.name[:80], 0.0) + e.self_device_time_total
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    out["top_kernels_ms"] = {name: t / 1e3 / steps for name, t in top}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh_seq_axis", type=int, default=1,
                    help="sequence shards of the mesh: > 1 runs ring attention over them")
    ap.add_argument("--fused_adamw", action="store_true",
                    help="the optimizer as one fused AdamW kernel launch (FusedAdamW)")
    ap.add_argument("--profile", action="store_true",
                    help="also print where a step's device time goes")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("neko_tpu_torch.bench: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, ctx, state, batch, batch_size = setup(args.config, "cuda", args.seed,
                                               args.mesh_seq_axis, args.fused_adamw)
    torch.cuda.reset_peak_memory_stats()
    m = measure(ctx, state, batch, cfg, batch_size, args.steps, args.warmup, args.seed)
    tokens_per_sec = m["tokens_per_sec"]
    fpt = train_flops_per_token(cfg, tgt_budget(batch_size, cfg) / (batch_size * cfg.context_len))
    name = torch.cuda.get_device_name(0)
    out = {
        "metric": metric_name(cfg),
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/sec/chip",
        "end_to_end": round(m["end_to_end"], 1),
        "e2e_over_device_step": round(m["e2e_over_device_step"], 3),
        "vs_baseline": round(tokens_per_sec / REFERENCE_TOKENS_PER_SEC_PER_CHIP, 3),
        "mfu": round(tokens_per_sec * fpt / PEAK_FLOPS[name], 4) if name in PEAK_FLOPS else None,
        "flops_per_token": round(fpt / 1e6, 1),
        "step_ms": round(m["step_ms"], 3),
        "peak_mem_gb": round(torch.cuda.max_memory_allocated() / 2 ** 30, 3),
        "device": name,
        "card": card(),
        "mesh_seq_axis": args.mesh_seq_axis,
        "fused_adamw": args.fused_adamw,
    }
    if args.profile:
        out["profile_ms_per_step"] = profile_breakdown(ctx, state, batch, cfg)
        out["optimizer_alone_ms"] = optimizer_ms(ctx, state, batch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
