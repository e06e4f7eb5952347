#!/usr/bin/env python3
"""Holds the port's training over a process group against its one-process
step:

    python tools/check_torch_parallel_ranks.py [--backend gloo|nccl]
        [--device cpu|cuda] [--data 2] [--model 1] [--seq 1] [--pipe 1]
        [--schedule gpipe|1f1b] [--micro 4] [--loss gathered|chunked]
        [--fsdp] [--fused_adamw] [--ema 0.0] [--dropout 0.0]
        [--width small|small4|flagship|flagship2] [--steps 3] [--fault NAME]
        [--state FILE] [--out FILE] [--timeout 600]

It spawns data x seq x pipe x model processes that join one
`torch.distributed` group at tcp://localhost:<a free port> and lay a
(data, seq, model) or (data, pipe, model) grid over it (`create_mesh`).
Every rank starts from one canonical state dict (random weights from the
seed, or `--state`, a torch file of one) and takes its
blocks of it (`TrainContext(mesh=, fsdp=)`); data rank d packs rows
[d * B / data, (d + 1) * B / data) of one global batch made from the numpy
seed: the root bench's row mix (text, continuous, image; bench.py
build_examples), 4 rows at the small width (128d / 2 layers / 4 heads,
k = 64, fp32; `small4` has 4 layers, so a pipeline stage holds two) and 16
at the flagship's (768d / 6 layers / 24 heads, k = 1024, bf16; `flagship2`
the same at 2 layers; `--k` and `--rows` change the context and the
rows).  'seq' and 'pipe' peers
pack their data coordinate's rows (each 'seq' rank keeps its columns on the
device); `--loss chunked` drops the gathered targets, so the loss takes the
chunked route (1F1B always does).  The two data halves hold different numbers of loss
targets, so a mean of per-rank means differs from the global mean.  Each
rank takes `--steps` steps; rank 0 then takes the same steps in one
process on the whole batch from the same state (under a one-device mesh
of `--seq` shards when 'seq' > 1: the ring on one device, whose masks are
the ranks' at any dropout).  Train-mode patch
positions are the interval midpoint on both sides: the one random draw a
data rank cannot share with one process.

`gloo` on `--device cpu` runs the kernels' plain versions; `gloo` on
`--device cuda` puts every rank on the one card (gloo carries the
collectives through host memory); `nccl` puts rank r on card r.

Prints one JSON line: the per-rank losses, the largest relative difference
of the losses (the steps' and `TrainContext.eval_step`'s after them) and of
the clip's global gradient norms from the one-process run's (`loss_err`,
`norm_err`), the relative L2 error of the whole tree's
update, gathered from the ranks, against its (`param_err`), the largest
difference between the copies of a leaf that several ranks hold
(`replica_err`, 0 when the ranks stay in step), the largest difference of
the model peers' own gradients of a leaf replicated over 'model' before the
sync averages them, relative to the gradient (`peer_grad_err`: 0 on the
CPU, the order of atomic sums on the card; peers drawing other masks than
each other show here), the kernels' launches per rank, the collectives' and
point-to-point sends' calls, bytes and ms per step (with the card
synchronised around each one), the step ms, peak bytes (of the steps, and
what their forward and backward allocate over what rests) and resting
bytes per rank
(parameters, optimizer moments and EMA between steps) and the one process's
resting bytes; under 'pipe' with dropout the share of a stage's outputs
that two microbatches of the same input give equal (`micro_mask_share`:
each draws its own masks, so ~rate^2 of them at most) and the most stage
inputs 1F1B held; `ok` when every difference is within its limit
(`--loss_tol`, `--param_tol`, `--norm_tol`, `--peer_tol`; dropout > 0
compares no losses with one process but under 'seq').  Exit 0 only when
ok.

`--fault NAME` plants one of FAULTS in the ranks (not in the one-process
run): what each check must see.  `run_ranks` runs several configurations
in one spawn of the ranks (chip_smoke.py phase 18); `cli_ranks` runs the
train CLI under a process group of ranks (`--multihost` reads the
torchrun environment each rank is given).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WIDTHS = {
    "small": dict(shape=dict(embed_dim=128, layers=2, heads=4, batch_per_chip=4,
                             context_len=64),
                  model=dict(dtype="float32", text_tokens=256, continuous_tokens=64,
                             discrete_tokens=64),
                  opt=dict(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2,
                           training_steps=100)),
    # lr 1e-3 from the first step (phase 13's three-step comparison): the
    # steps move the weights, so a wrong gradient shows in the later losses
    "small4": dict(shape=dict(embed_dim=128, layers=4, heads=4, batch_per_chip=4,
                              context_len=64),
                   model=dict(dtype="float32", text_tokens=256, continuous_tokens=64,
                              discrete_tokens=64),
                   opt=dict(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2,
                            training_steps=100)),
    "flagship": dict(shape=dict(embed_dim=768, layers=6, heads=24, batch_per_chip=16),
                     model=dict(),
                     opt=dict(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                              disable_cosine_decay=True, training_steps=10_000)),
    # the flagship cut to 2 layers (chip_smoke.py phases 18 and 19 (a), whose
    # run must end within its time limit)
    "flagship2": dict(shape=dict(embed_dim=768, layers=2, heads=24, batch_per_chip=16),
                      model=dict(),
                      opt=dict(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                               disable_cosine_decay=True, training_steps=10_000)),
}
FAULTS = ("mean of local means", "row-parallel all-reduce dropped",
          "out-of-shard targets clipped", "FSDP clip norm from the local shard",
          "model peers draw different dropout masks",
          # 'seq' over ranks
          "boundary target dropped", "seq peers share a mask",
          "gradients not summed over 'seq'",
          # 'pipe'
          "clip norm from the stage's own leaves", "embedding gradient only on stage 0",
          "mean of microbatch means", "every microbatch shares one mask")
# under 'pipe' with dropout: two microbatches of one input give equal stage
# outputs where they share every mask on the element's path (the planted
# "every microbatch shares one mask": all of them)
MICRO_SHARE_TOL = 0.5
RUN_KEYS = dict(data=1, model=1, seq=1, pipe=1, schedule="gpipe", micro=4, loss="gathered",
                fsdp=False, fused_adamw=False, ema=0.0, dropout=0.0, fault=None, k=None,
                rows=None)


def ranks_of(run) -> int:
    return run["data"] * run["model"] * run["seq"] * run["pipe"]


def model_config(width: str, dropout: float = 0.0, k: int = None):
    from neko_tpu_torch import bench

    w = WIDTHS[width]
    shape = dict(w["shape"], **({"context_len": k} if k else {}))
    return bench.model_config(shape).replace(dropout=dropout, **w["model"])


def optimizer_config(width: str, run: dict):
    from neko_tpu_torch.training.train_state import OptimizerConfig

    return OptimizerConfig(**WIDTHS[width]["opt"], fused_adamw=run["fused_adamw"],
                           ema_decay=run["ema"], pipeline_microbatches=run["micro"],
                           pipeline_schedule=run["schedule"])


def batch_arrays(cfg, width: str, seed: int = 0, data: int = 1, index: int = 0,
                 loss: str = "gathered", rows: int = None):
    """Packed arrays of data rank `index`'s rows of the global batch (all of
    it with data 1), with the global batch's patch and target budgets;
    `loss` "chunked" leaves out the gathered targets."""
    from neko_tpu_torch import bench
    from neko_tpu_torch.data.packing import SequencePacker

    rows = rows or WIDTHS[width]["shape"]["batch_per_chip"]
    examples = bench.build_examples(cfg, rows, seed)
    n = rows // data
    arrays = SequencePacker(cfg).pack_batch(
        examples[index * n:(index + 1) * n], patch_budget=bench.patch_budget(cfg, rows),
        target_budget=bench.tgt_budget(rows, cfg))
    arrays.pop("lengths")
    if loss == "chunked":
        arrays.pop("loss_pos")
        arrays.pop("loss_tgt")
    return arrays


def launch_counters():
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as blk
    from neko_tpu_torch.ops import decode_attention as da
    from neko_tpu_torch.ops import fused_adamw as fa
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.ops import ring_kernel as rk

    return {"fwd": whk.whole_head_attention, "bwd": whk.whole_head_attention_bwd,
            "blocked_fwd": blk.blocked_attention_fwd, "decode": da.decode_cache_attention,
            "loss": lk.fused_logz_tl, "adamw": fa.fused_adamw_apply,
            "ring_fwd": rk.ring_partial_fwd, "ring_dq": rk.ring_partial_dq,
            "ring_dkv": rk.ring_partial_dkv}


@contextlib.contextmanager
def midpoint_patch_positions():
    """Train-mode patch positions at the interval midpoint (eval mode's rule)."""
    import torch

    from neko_tpu_torch.models.embeddings import PatchPosEncoding

    orig = PatchPosEncoding.__dict__["sample"]
    PatchPosEncoding.sample = staticmethod(
        lambda lo, hi, g: torch.round((lo + torch.clamp(hi, min=lo + 1) - 1) / 2.0).long())
    try:
        yield
    finally:
        PatchPosEncoding.sample = orig


@contextlib.contextmanager
def planted(fault, mesh):
    """One of FAULTS in this process's code (None: nothing)."""
    import torch

    from neko_tpu_torch.ops import dropout, losses
    from neko_tpu_torch.parallel import collectives, pipeline
    from neko_tpu_torch.parallel.collectives import LOCAL
    from neko_tpu_torch.training.train_state import TrainContext

    def without_axis(method, name):  # `method` run with the context's axis `name` off
        def run(self, *a):
            kept = getattr(self, name)
            setattr(self, name, LOCAL)
            try:
                return method(self, *a)
            finally:
                setattr(self, name, kept)
        return run

    swaps = []
    if fault == "mean of local means":  # each rank's mean, averaged over the ranks
        def local_mean(mask, axes):
            n = 1
            for ax in (axes,) if isinstance(axes, collectives.Axis) else axes:
                n *= ax.size
            return mask.sum().clamp(min=1.0) * n
        swaps.append((losses, "_count", local_mean))
    elif fault == "row-parallel all-reduce dropped":
        rows = collectives.row_parallel
        swaps.append((collectives, "row_parallel", lambda x, w, axis: rows(x, w, LOCAL)))
    elif fault == "out-of-shard targets clipped":
        local = losses.local_vocab

        def clipped(t, rows, valid, axis):
            t, valid = local(t, rows, valid, axis)
            return t.clamp(0, rows - 1), valid
        swaps.append((losses, "local_vocab", clipped))
    elif fault == "FSDP clip norm from the local shard":
        def local_norm(self, model):
            return torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(p.grad, dtype=torch.float32)
                for p in self.trained_parameters(model).values() if p.grad is not None]))
        swaps.append((TrainContext, "grad_norm", local_norm))
    elif fault == "model peers draw different dropout masks":
        draw, peer = dropout.materialized_dropout, mesh.axis("model").index

        def skewed(x, rate, g):
            if g is not None and peer:
                g = torch.Generator(device=g.device).manual_seed(
                    int(torch.randint(1 << 30, (1,), generator=g, device=g.device)) + peer)
            return draw(x, rate, g)
        swaps.append((dropout, "materialized_dropout", skewed))
    elif fault == "boundary target dropped":  # the shift taken within the rank's columns
        targets = losses.next_token_targets

        def within(tokens, input_mask, target_mask, col_offset=0, cols=None):
            sl = slice(col_offset, None if cols is None else col_offset + cols)
            return targets(tokens[:, sl], input_mask[:, sl], target_mask[:, sl])
        swaps.append((losses, "next_token_targets", within))
    elif fault == "seq peers share a mask":  # each draws the mask of its columns' shape
        def shared(x, rate, g):
            q = dropout.keep_threshold(rate)
            if g is None or q == 0:
                return x
            bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device,
                                 generator=g)
            return torch.where(bits >= q, x * (1.0 / (1.0 - q / 256.0)), 0)
        swaps.append((dropout, "materialized_dropout", shared))
    elif fault == "gradients not summed over 'seq'":
        swaps.append((TrainContext, "sync_grads",
                      without_axis(TrainContext.sync_grads, "seq_axis")))
    elif fault == "clip norm from the stage's own leaves":
        swaps.append((TrainContext, "grad_norm",
                      without_axis(TrainContext.grad_norm, "pipe_axis")))
    elif fault == "embedding gradient only on stage 0":
        sync, real = TrainContext.sync_grads, pipeline.is_stage_leaf

        def stage0(self, state):  # the embedding taken for a stage's own leaf
            pipeline.is_stage_leaf = lambda k: real(k) or k == "embed_token.weight"
            try:
                sync(self, state)
            finally:
                pipeline.is_stage_leaf = real
        swaps.append((TrainContext, "sync_grads", stage0))
    elif fault == "mean of microbatch means":
        swaps.append((pipeline, "micro_loss",
                      lambda total, count, inv_total, n_micro:
                      total / count.clamp(min=1.0) / n_micro))
    elif fault == "every microbatch shares one mask":
        seed_of = pipeline.layer_seed
        swaps.append((pipeline, "layer_seed", lambda step, micro, layer: seed_of(step, 0, layer)))
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, fn in swaps:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peer_grad_err(ctx, state) -> float:
    """Before the gradient sync: the largest difference between the model
    peers' gradients of a leaf replicated over 'model', relative to the
    leaf's largest gradient (each peer computes the whole of it)."""
    from neko_tpu_torch.parallel.collectives import all_gather_cat

    worst = 0.0
    for name, p in state.model.named_parameters():
        if p.grad is not None and ctx.replicated_over_model(name):
            g = all_gather_cat(p.grad.float().reshape(1, -1), 0, ctx.model_axis)
            worst = max(worst, float((g - g[:1]).abs().max() / g.abs().max().clamp(min=1e-30)))
    return worst


def _steps(ctx, state, batch, steps: int):
    """`steps` train steps, each split as train_step splits it, with the
    model peers' gradient difference before the sync and the clip's global
    norm read out (their collectives left out of the counts).  -> (losses,
    norms, ms per step, peer gradient difference, {"step": the peak
    allocated bytes, "activations": the most the forward and backward
    allocated over what rested before them})."""
    from neko_tpu_torch.parallel.collectives import stats

    losses, norms, ms, peer = [], [], [], 0.0
    peaks = {"step": 0, "activations": 0}
    for _ in range(steps):
        _sync(ctx.device)
        t0 = time.perf_counter()
        resting = _peak(ctx.device)[1]
        part = ctx.forward_backward(state, batch)
        fb_peak = _peak(ctx.device)[0]
        peaks["activations"] = max(peaks["activations"], fb_peak - resting)
        peaks["step"] = max(peaks["step"], fb_peak)
        kept = (stats.calls, stats.bytes, stats.seconds)
        peer = max(peer, _peer_grad_err(ctx, state))
        stats.calls, stats.bytes, stats.seconds = kept
        ctx.sync_grads(state)
        kept = (stats.calls, stats.bytes, stats.seconds)
        norm = ctx.grad_norm(state.model)
        stats.calls, stats.bytes, stats.seconds = kept
        ctx.apply_gradients(state)
        loss = ctx.global_loss(part)
        _sync(ctx.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        peaks["step"] = max(peaks["step"], _peak(ctx.device)[0])
        losses.append(loss.item())
        norms.append(norm.item())
    return losses, norms, ms, peer, peaks


def _peak(device):
    """(the card's peak allocated bytes since the last call, the bytes
    allocated now); (0, 0) on the CPU."""
    import torch

    if device.type != "cuda":
        return 0, 0
    peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    return peak, torch.cuda.memory_allocated(device)


def _resting_bytes(state) -> int:
    """Bytes of the parameters, the optimizer's moments and the EMA."""
    import torch

    n = sum(p.numel() * p.element_size() for p in state.model.parameters())
    for st in state.optimizer.state.values():
        if isinstance(st, dict):
            n += sum(v.numel() * v.element_size() for v in st.values()
                     if torch.is_tensor(v) and v.dim() > 0)
    if state.ema is not None:
        n += sum(v.numel() * v.element_size() for v in state.ema.values())
    return n


def _replica_err(ctx, state) -> float:
    """Largest difference between the copies of each leaf that several
    ranks hold (the replicated leaves over 'model', the leaves not split
    over 'data' over it, every leaf over 'seq', the root leaves over
    'pipe')."""
    from neko_tpu_torch.parallel import pipeline
    from neko_tpu_torch.parallel.collectives import all_gather_cat

    worst = 0.0
    for name, p in state.model.named_parameters():
        spec = ctx.layout[name]
        for ax, split in ((ctx.model_axis, spec.model_dim), (ctx.data_axis, spec.data_dim),
                          (ctx.seq_axis, None),
                          (ctx.pipe_axis, 0 if pipeline.is_stage_leaf(name) else None)):
            if ax.on and split is None:
                copies = all_gather_cat(p.detach().float().reshape(1, -1), 0, ax)
                worst = max(worst, float((copies - copies[:1]).abs().max()))
    return worst


def _micro_mask_share(ctx, state, device) -> float:
    """The share of a stage's outputs that microbatches 0 and 1 of one
    input give equal under dropout (1.0 when they share masks)."""
    import torch

    from neko_tpu_torch.parallel import pipeline

    cfg = state.model.cfg
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(2, 32, cfg.embed_dim, device=device, generator=g).to(cfg.activation_dtype)
    mask = torch.ones(2, 32, dtype=torch.bool, device=device)
    with torch.no_grad(), ctx.mesh:
        ys = [pipeline.stage_forward(state.model, x, mask, m, ctx.pipe_axis.index, 12345)
              for m in (0, 1)]
    return float((ys[0] == ys[1]).float().mean())


def _update_err(got, want, start) -> float:
    """The relative L2 error of the whole tree's update: |got - want| over
    |want - start| (Adam moves an element by ~lr wherever |g| >> eps and
    turns on the rounding of g where g ~ 0, so no element alone tells)."""
    num = den = 0.0
    for n, w in want.items():
        num += float((got[n].float().to(w.device) - w.float()).norm()) ** 2
        den += float((w.float() - start[n].to(w.device).float()).norm()) ** 2
    return (num / max(den, 1e-30)) ** 0.5


def _one_process(cfg, opt, sd, run, width, seed, device, steps):
    """The same steps in one process on the whole batch (under a one-device
    mesh of the run's 'seq' shards): (losses and the evaluation loss after
    them, norms, canonical parameters, resting bytes)."""
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.parallel.mesh import device_mesh
    from neko_tpu_torch.training.train_state import TrainContext

    mesh = device_mesh(run["seq"]) if run["seq"] > 1 else None
    ctx = TrainContext(cfg, opt, device=device, seed=seed, mesh=mesh)
    state = ctx.init_state({k: v.clone() for k, v in sd.items()})
    batch = to_device_batch(batch_arrays(cfg, width, seed, loss=run["loss"], rows=run["rows"]),
                            device)
    losses, norms, _, _, _ = _steps(ctx, state, batch, steps)
    # kept on the host: rank 0 keeps it across runs, and it must not hold card memory
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    return losses + [ctx.eval_step(state, batch).item()], norms, params, _resting_bytes(state)


def compared(run) -> bool:
    """Whether a run is held to the one-process run: at dropout 0, and under
    'seq' at any rate (the one-device shards draw the ranks' masks)."""
    return run["dropout"] == 0.0 or run["seq"] > 1


def _run(rank, run, width, seed, device, steps, sd, cache, out):
    import torch

    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.parallel.collectives import stats
    from neko_tpu_torch.parallel.mesh import create_mesh
    from neko_tpu_torch.training.train_state import TrainContext

    cfg = model_config(width, run["dropout"], run["k"])
    opt = optimizer_config(width, run)
    mesh = create_mesh(data=run["data"], model=run["model"], seq=run["seq"], pipe=run["pipe"])
    ctx = TrainContext(cfg, opt, device=device, seed=seed, fsdp=run["fsdp"], mesh=mesh)
    state = ctx.init_state(sd)
    d = mesh.axis("data").index
    batch = to_device_batch(batch_arrays(cfg, width, seed, run["data"], d, run["loss"],
                                         run["rows"]), device)
    counters = launch_counters()
    with planted(run["fault"], mesh):
        for fn in counters.values():
            fn.launches = 0
        stats.reset()
        stats.timed = True
        try:
            losses, norms, ms, peer, peaks = _steps(ctx, state, batch, steps)
        finally:
            stats.timed = False
        launches = {k: fn.launches for k, fn in counters.items()}
        eval_loss = ctx.eval_step(state, batch).item()
        share = (_micro_mask_share(ctx, state, device)
                 if run["pipe"] > 1 and run["dropout"] > 0 else None)
    res = {"rank": rank, "coords": [mesh.axis(a).index for a in ("data", "model")],
           "seq_pipe": [mesh.axis("seq").index, mesh.axis("pipe").index],
           "losses": losses, "eval_loss": eval_loss, "norms": norms, "step_ms": ms,
           "launches": launches,
           "collective": {"calls": stats.calls / steps, "bytes": stats.bytes / steps,
                          "ms": stats.seconds * 1e3 / steps},
           "peak_bytes": peaks["step"] if device.type == "cuda" else None,
           "activation_peak_bytes": peaks["activations"] if device.type == "cuda" else None,
           "resting_bytes": _resting_bytes(state),
           "local_shapes": {n: list(p.shape) for n, p in state.model.named_parameters()},
           # #15's launches a step of the loss over this rank's rows: the
           # gathered route's 4096-entry chunks, or the chunked route's
           # 256-column chunks (of a microbatch under 1F1B)
           "loss_chunks": (-(-batch.loss_pos.shape[0] // 4096)
                           if batch.loss_pos is not None and run["schedule"] != "1f1b"
                           else -(-batch.tokens.shape[1] // run["seq"] // 256)),
           "micro_mask_share": share,
           "peak_saved_inputs": (ctx.last_schedule or {}).get("peak_saved_inputs")}
    res["replica_err"] = _replica_err(ctx, state)
    res["peer_grad_err"] = peer
    gathered = ctx.gather_named({n: p.detach() for n, p in state.model.named_parameters()})
    if rank == 0 and compared(run):
        key = (run["fused_adamw"], run["ema"], run["seq"], run["loss"], run["dropout"])
        if key not in cache:
            cache[key] = _one_process(cfg, opt, sd, run, width, seed, device, steps)
        ref_losses, ref_norms, ref_params, ref_bytes = cache[key]
        res.update(
            one_process={"losses": ref_losses, "norms": ref_norms, "resting_bytes": ref_bytes},
            # the steps' losses and the evaluation loss after them
            loss_err=max(abs(a - b) / abs(b)
                         for a, b in zip(losses + [eval_loss], ref_losses)),
            norm_err=max(abs(a - b) / abs(b) for a, b in zip(norms, ref_norms)),
            param_err=_update_err(gathered, ref_params, sd))
    if rank == 0 and out:
        torch.save({"params": {k: v.cpu() for k, v in gathered.items()}, "losses": losses}, out)
    return res


def _worker(rank, world, backend, device_kind, width, runs, seed, steps, state_path, port,
            outdir, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        if device_kind == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        from neko_tpu_torch.convert import init_state_dict

        cfg = model_config(width, k=runs[0]["k"])
        sd = (torch.load(state_path, map_location="cpu", weights_only=True) if state_path
              else init_state_dict(cfg, seed))
        cache = {}
        results = []
        with midpoint_patch_positions():
            for i, run in enumerate(runs):
                # several runs: rank 0's parameters of run i to <out>.<i>
                path = out if not out or len(runs) == 1 else f"{out}.{i}"
                results.append(_run(rank, run, width, seed, device, steps, sd, cache, path))
                dist.barrier()
        with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, args, nprocs: int, timeout: float):
    """Run fn(rank, *args) in `nprocs` spawned processes; stop them all and
    raise when one has not ended after `timeout` seconds."""
    import torch.multiprocessing as mp

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    procs = mp.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    while not procs.join(timeout=1.0):  # True once every rank has ended; raises if one failed
        if time.monotonic() > deadline:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
            raise TimeoutError(f"the ranks did not end within {timeout} s")


def run_ranks(runs, *, backend="gloo", device="cuda", width="flagship", steps=3, seed=0,
              state=None, out=None, timeout=600.0):
    """Every configuration of `runs` (dicts of RUN_KEYS; one number of
    ranks and one context) in one spawn of the ranks.  -> one result per
    run: its per-rank readings under "ranks", and rank 0's comparisons at
    the top.  `out`: rank 0's gathered parameters and losses (of run i at
    <out>.<i> when there are several)."""
    runs = [dict(RUN_KEYS, **r) for r in runs]
    world = ranks_of(runs[0])
    if any(ranks_of(r) != world or r["k"] != runs[0]["k"] for r in runs):
        raise ValueError("the runs of one spawn need one number of ranks and one context")
    with tempfile.TemporaryDirectory() as outdir:
        _spawn(_worker, (world, backend, device, width, runs, seed, steps, state,
                         _free_port(), outdir, out), world, timeout)
        per_rank = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank_{r}.json")) as f:
                per_rank.append(json.load(f))
    results = []
    for i, run in enumerate(runs):
        ranks = [per_rank[r][i] for r in range(world)]
        top = {k: ranks[0].get(k) for k in ("loss_err", "norm_err", "param_err", "one_process")}
        top["replica_err"] = max(r["replica_err"] for r in ranks)
        top["peer_grad_err"] = max(r["peer_grad_err"] for r in ranks)
        shares = [r["micro_mask_share"] for r in ranks if r["micro_mask_share"] is not None]
        top["micro_mask_share"] = max(shares) if shares else None
        results.append(dict(run=run, ranks=ranks, **top))
    return results


def _cli_worker(rank, world, argv, port, cpu, outdir, params):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from neko_tpu_torch.cli import train as cli_train
    from neko_tpu_torch.parallel import multihost as mh

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    trainer = cli_train.main(list(argv) + ["--multihost"] + (["--cpu"] if cpu else []))
    launches = {k: fn.launches for k, fn in counters.items()}
    if params:  # the canonical parameters the ranks end with
        sd = mh.eval_replica(trainer.ctx, trainer.state)
        if rank == 0:
            torch.save({k: v.cpu() for k, v in sd.items()}, os.path.join(outdir, "params.pt"))
    with open(os.path.join(outdir, f"cli_{rank}.json"), "w") as f:
        json.dump({"launches": launches, "exp_dir": trainer.exp_dir, "steps": trainer.steps,
                   "mesh": trainer.ctx.mesh.shape, "local_shapes": {
                       n: list(p.shape) for n, p in trainer.state.model.named_parameters()}},
                  f)
    dist.destroy_process_group()


def cli_ranks(argv, ranks: int = 2, *, cpu=False, params=False, timeout=600.0):
    """`python -m neko_tpu_torch.cli.train <argv> --multihost` in `ranks`
    spawned processes, each given torchrun's environment.  -> (per rank
    {"launches", "exp_dir", "steps", "mesh", "local_shapes"}, and with
    `params` the canonical parameters the run ends with, else None)."""
    import torch

    with tempfile.TemporaryDirectory() as outdir:
        _spawn(_cli_worker, (ranks, argv, _free_port(), cpu, outdir, params), ranks, timeout)
        out = []
        for r in range(ranks):
            with open(os.path.join(outdir, f"cli_{r}.json")) as f:
                out.append(json.load(f))
        sd = (torch.load(os.path.join(outdir, "params.pt"), weights_only=True)
              if params else None)
    return out, sd


def summary(res: dict, tols) -> dict:
    """The JSON line of one run: its readings and whether they are within
    `tols` (loss, param, norm, peer)."""
    ranks = res["ranks"]
    loss_tol, param_tol, norm_tol, peer_tol = tols
    held = compared(res["run"])
    ok = (res["replica_err"] == 0.0 and res["peer_grad_err"] <= peer_tol
          and all(np.isfinite(r["losses"]).all() for r in ranks)
          and (res["micro_mask_share"] is None or res["micro_mask_share"] <= MICRO_SHARE_TOL))
    if held:
        ok = ok and (res["loss_err"] <= loss_tol and res["param_err"] <= param_tol
                     and res["norm_err"] <= norm_tol)
    return {"run": res["run"], "losses": [r["losses"] for r in ranks],
            "loss_err": res["loss_err"] if held else None,
            "param_err": res["param_err"] if held else None,
            "norm_err": res["norm_err"] if held else None,
            "replica_err": res["replica_err"], "peer_grad_err": res["peer_grad_err"],
            "micro_mask_share": res["micro_mask_share"],
            "peak_saved_inputs": [r["peak_saved_inputs"] for r in ranks],
            "launches": [r["launches"] for r in ranks],
            "collective": [r["collective"] for r in ranks],
            "step_ms": [r["step_ms"] for r in ranks],
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "activation_peak_bytes": [r["activation_peak_bytes"] for r in ranks],
            "resting_bytes": [r["resting_bytes"] for r in ranks],
            "local_shapes": [r["local_shapes"] for r in ranks],
            "coords": [r["coords"] for r in ranks],
            "seq_pipe": [r["seq_pipe"] for r in ranks],
            "one_process_resting_bytes": (res["one_process"]["resting_bytes"] if held
                                          else None),
            "tols": {"loss": loss_tol, "param": param_tol, "norm": norm_tol, "peer": peer_tol},
            "ok": bool(ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1)
    ap.add_argument("--pipe", type=int, default=1)
    ap.add_argument("--schedule", choices=("gpipe", "1f1b"), default="gpipe")
    ap.add_argument("--micro", type=int, default=4, help="pipeline microbatches")
    ap.add_argument("--loss", choices=("gathered", "chunked"), default="gathered")
    ap.add_argument("--k", type=int, default=None, help="the context (the width's by default)")
    ap.add_argument("--rows", type=int, default=None, help="the global batch's rows")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--fused_adamw", action="store_true")
    ap.add_argument("--ema", type=float, default=0.0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--width", choices=sorted(WIDTHS), default="flagship")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    ap.add_argument("--state", default=None, help="a torch file of the canonical state dict")
    ap.add_argument("--out", default=None, help="write rank 0's gathered parameters here")
    ap.add_argument("--loss_tol", type=float, default=2e-4)
    ap.add_argument("--param_tol", type=float, default=1e-4)
    ap.add_argument("--norm_tol", type=float, default=1e-4)
    ap.add_argument("--peer_tol", type=float, default=1e-4)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    run = {k: getattr(args, k) for k in RUN_KEYS}
    n = ranks_of(run)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_torch_parallel_ranks: --device cuda but no CUDA device is visible "
              "(--device cpu runs the plain versions)", file=sys.stderr)
        return 2
    if args.backend == "nccl" and (args.device != "cuda" or torch.cuda.device_count() < n):
        print(f"check_torch_parallel_ranks: nccl needs {n} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_ranks([run], backend=args.backend, device=args.device, width=args.width,
                    steps=args.steps, seed=args.seed, state=args.state, out=args.out,
                    timeout=args.timeout)[0]
    line = summary(res, (args.loss_tol, args.param_tol, args.norm_tol, args.peer_tol))
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(json.dumps({"backend": args.backend, "device": name, "ranks": n,
                      "width": args.width, "steps": args.steps, **line}))
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
