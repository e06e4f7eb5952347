"""A training cell: `TrainContext.train_step` fed by the port's
`HostPrefetcher`, which packs each step's rows with `SequencePacker` on its
thread and copies them to the device, as the Trainer feeds its steps.

Set-up builds the one train state from the seed, drives it through the
checked steps with the window's own call and feed (their losses, the first
gradient as the optimizer holds it, the parameters' change over them),
warms up, then hands the same state to the window.  After the window the
program's state is freed and the plain reference follows the checked steps
from the same weights, rows and draws."""

from __future__ import annotations

import gc
import itertools
import statistics
import time
from typing import Dict

import torch

from portbench import flops, weights
from portbench.generators import train_rows
from portbench.reference import model as ref_model
from portbench.reference import optim as ref_optim
from portbench.reference import packing as ref_packing
from portbench.trace import Capture, Spans


def program_seed(seed: int) -> int:
    """The seed handed to the program's TrainContext (its step generators
    are keyed ((seed + 1) << 32) + step, which must stay under 2**64)."""
    return int(seed) % (2 ** 31 - 1)


def step_seed(pseed: int, step: int) -> int:
    """The seed of step `step`'s generator, as the configuration keys it."""
    return ((pseed + 1) << 32) + step


def model_config(m: dict, t: dict):
    from neko_tpu_torch.config import ModelConfig

    per = train_rows.patches_per_image(t, m.get("patch_size", 16))
    return ModelConfig(**m, max_patches=t["image"]["timesteps"] * per)


def rows_per_chip(config: dict, t: dict) -> int:
    return t["global_rows"] // config["deployment"]["train_gpus"]


class Ranks:
    """This process's place among the ranks of a data-parallel cell (one
    rank: no process group), and a gloo group for the host's agreements
    (when to stop, the maxima): they never wait for the device."""

    def __init__(self):
        import torch.distributed as dist

        self.dist = dist
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if self.world > 1 else 0
        self.host = dist.new_group(backend="gloo") if self.world > 1 else None

    def agree(self, x: float, op: str = "max") -> float:
        if self.host is None:
            return x
        d = self.dist
        v = torch.tensor([float(x)], dtype=torch.float64)
        d.all_reduce(v, op=d.ReduceOp.MAX if op == "max" else d.ReduceOp.SUM, group=self.host)
        return float(v[0])

    def go(self, mine: bool) -> bool:
        """Rank 0's decision, on every rank."""
        if self.host is None:
            return mine
        v = torch.tensor([int(mine)])
        self.dist.broadcast(v, 0, group=self.host)
        return bool(v[0])

    def barrier(self) -> None:
        if self.host is not None:
            self.dist.barrier(group=self.host)


def run(run, config: dict, t: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", rows: int = None) -> None:
    """Fill `run` (harness.Run) with the cell's readings and its checks.  In
    a process group every rank runs this on its own device with its own
    rows (a data-parallel step over create_mesh(data=ranks)); rank 0's
    `run` holds the cell's readings."""
    from neko_tpu_torch.convert import model_shapes
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.data.packing import SequencePacker
    from neko_tpu_torch.data.pipeline import HostPrefetcher
    from neko_tpu_torch.parallel.mesh import create_mesh
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    rk = Ranks()
    m, o = config["model"], t["optimizer"]
    rows = rows or rows_per_chip(config, t)
    cfg = model_config(m, t)
    pseed = program_seed(seed)
    bud = train_rows.budgets(t, rows, m.get("patch_size", 16))
    pools = train_rows.pools(t, m["text_tokens"], rows, seed, rk.rank)
    mesh = create_mesh(data=rk.world) if rk.world > 1 else None

    sd = weights.make(m, seed, device, torch.float32)
    theirs = {k: tuple(v) for k, v in model_shapes(cfg).items()}
    if theirs != {k: tuple(v.shape) for k, v in sd.items()}:
        raise RuntimeError("the program's parameter tree is not the configuration's")
    ctx = TrainContext(cfg, OptimizerConfig(**o), device=device, seed=pseed, mesh=mesh)
    state = ctx.init_state({k: v.clone() for k, v in sd.items()})
    del sd
    packer = SequencePacker(cfg)
    turn = itertools.count()

    def produce():
        arrays = packer.pack_batch(pools[next(turn) % len(pools)], **bud)
        arrays.pop("lengths")
        return to_device_batch(arrays, device, non_blocking=True)

    pf = HostPrefetcher(produce, depth=2, device=device)
    spans = Spans()
    try:
        # -- the checked steps: the window's own call and feed
        named = list(state.model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in named}
        losses, grad1 = [], {}
        for i in range(t["checked_steps"]):
            _, loss = ctx.train_step(state, pf.get())
            losses.append(float(loss))
            if i == 0:
                for n, p in named:
                    st = state.optimizer.state.get(p, {})
                    mu = st.get("exp_avg")
                    grad1[n] = (0.0 if mu is None else
                                float(torch.linalg.vector_norm(mu.double())) / (1 - o["beta_1"]))
        delta = {n: (p.detach() - p0[n]).cpu() for n, p in named}
        del p0
        for _ in range(t.get("warm_steps", 0)):
            ctx.train_step(state, pf.get())
        sync(device)
        t_step = time.monotonic()
        ctx.train_step(state, pf.get())
        sync(device)
        est = rk.agree(time.monotonic() - t_step)

        # -- the window
        cap = Capture() if trace else None
        main_s = seconds - (est * (t["capture_steps"] + 0.5) if trace else 0.0)
        rk.barrier()
        run.window_start = t0 = time.monotonic()
        steps = 0
        while rk.go(time.monotonic() - t0 < main_s):
            with spans("train.host_wait"):
                batch = pf.get()
            with spans("train.step"):
                ctx.train_step(state, batch)
            steps += 1
        sync(device)
        rk.barrier()
        t_main = time.monotonic()
        cap_steps = 0
        if cap is not None:
            cap.start()
            for _ in range(t["capture_steps"]):
                with spans("train.host_wait"):
                    batch = pf.get()
                with spans("train.step"):
                    ctx.train_step(state, batch)
                cap_steps += 1
            cap.stop()
            rk.barrier()
        t1 = time.monotonic()
    finally:
        pf.close()
    run.memory_peak = rk.agree(torch.cuda.max_memory_allocated(device) if device != "cpu" else 0)
    # every pool packs to the same lengths: the counts of one batch hold for all
    ref0 = ref_packing.pack_batch(pools[0], m, **bud)
    n_targets = int((ref0["loss_pos"][:, 0] < rows).sum())
    D, L, S = m["embed_dim"], m["layers"], m["context_len"]
    vocab, V, _ = weights.vocab_sizes(m)
    run.readings.update({
        "steps": steps + cap_steps, "main_steps": steps, "main_s": t_main - t0,
        "window_s": t1 - t0, "tokens_per_step": rows * S, "rows": rows,
        "flops_per_token": flops.train_flops_per_token(D, L, S, V, n_targets / (rows * S)),
        "ranks": rk.world,
        "layers": L, "heads": m["heads"], "head_dim": D // m["heads"], "seq": S, "dim": D,
        "vocab": vocab, "lengths": ref0["input_mask"].sum(1).tolist(),
        "targets": n_targets, "loss_rows": bud["target_budget"],
        "host_wait_s": [b - a for a, b in spans.between("train.host_wait", t0, t_main)],
    })
    run.attempted, run.failed = steps + cap_steps, 0
    if cap is not None:
        run.capture = cap.reading(spans)
        run.readings["capture_steps"] = cap_steps
        run.readings["busy_s"] = rk.agree(run.capture.busy_s, "sum") / rk.world
    del state, ctx, pf, named
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    check(run, m, t, seed, pseed, rows, bud, pools, losses, grad1, delta, device, rk)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


RANK_SEED = 100_003  # a data rank's offset of its step and attention seeds


def reference_steps(m: dict, t: dict, seed: int, pseed: int, rows: int, bud: dict, pools,
                    device, precision: str = "fp32", keep_rows: int = None,
                    rank: int = 0, world: int = 1, exchange: bool = True):
    """The reference through the checked steps.  Over `world` ranks each
    computes its own rows' share of the global batch's gradients with its
    own draws (step and attention seeds offset by rank * 100,003) and the
    shares are summed (torch.distributed), unless `exchange` is off (a
    planted fault).  -> (losses, first clipped gradient by leaf, change by
    leaf)."""
    import torch.distributed as dist

    W = {n: v.clone().requires_grad_(True) for n, v in
         weights.make(m, seed, device, torch.float32).items()}
    W0 = {n: v.detach().clone() for n, v in W.items()}
    opt = ref_optim.AdamW(W, t["optimizer"])
    losses, grad1 = [], None
    total = lambda x: (dist.all_reduce(x) or x) if world > 1 else x  # noqa: E731
    for step in range(t["checked_steps"]):
        arrays = ref_packing.pack_batch(pools[step % len(pools)], m, **bud)
        batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        draws = ref_model.step_draws(step_seed(pseed + rank * RANK_SEED, step), rows,
                                     m["context_len"], m["embed_dim"], bud["patch_budget"],
                                     m["layers"], device, rank * RANK_SEED)
        kept = rows if keep_rows is None else keep_rows
        mine = float((batch["loss_pos"][:, 0] < kept).sum())
        count = float(total(torch.tensor([mine], dtype=torch.float64, device=device))[0])
        loss = ref_model.train_loss_and_grads(
            W, m, batch, draws, t["reference_rows_per_block"], precision, keep_rows, count)
        losses.append(float(total(torch.tensor([loss], dtype=torch.float64, device=device))[0]))
        if world > 1 and exchange:
            flat = total(torch.cat([w.grad.reshape(-1) for w in W.values()]))
            for w, part in zip(W.values(), flat.split([w.numel() for w in W.values()])):
                w.grad.copy_(part.view_as(w))
        g = opt.clip()
        if step == 0:
            grad1 = {n: x.detach().clone() for n, x in g.items()}
        opt.step(g)
        del draws, batch
    return losses, grad1, {n: (W[n].detach() - W0[n]) for n in W}


def gaps(ref: Dict[str, float], prog: Dict[str, float]) -> float:
    """The worst leaf's |prog - ref|, against the larger of the leaf's
    reference value and the median leaf's."""
    med = statistics.median(ref.values())
    return max(abs(prog[n] - r) / max(r, med) for n, r in ref.items())


def compare(ref, prog_losses, prog_grad1: Dict[str, float], prog_delta) -> Dict[str, float]:
    """The three numbers compared: the worst step's loss gap, the worst
    leaf's first-gradient norm gap, the worst leaf's change norm gap over
    the elements whose reference gradient is at least a thousandth of the
    median leaf's RMS gradient."""
    losses, grad1, delta = ref
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog_losses, losses))
    gnorm = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grad1.items()}
    rms = statistics.median(float(g.double().pow(2).mean().sqrt()) for g in grad1.values())
    keep = {n: g.abs() >= 1e-3 * rms for n, g in grad1.items()}
    dref, dprog = {}, {}
    for n, k in keep.items():
        if bool(k.any()):
            dref[n] = float(torch.linalg.vector_norm(delta[n][k].double()))
            dprog[n] = float(torch.linalg.vector_norm(
                prog_delta[n].to(k.device)[k].double()))
    return {"loss_gap": loss_gap, "grad_gap": gaps(gnorm, prog_grad1),
            "change_gap": gaps(dref, dprog)}


def check(run, m, t, seed, pseed, rows, bud, pools, losses, grad1, delta, device,
          rk: Ranks) -> None:
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = reference_steps(m, t, seed, pseed, rows, bud, pools, device,
                              rank=rk.rank, world=rk.world)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if rk.rank == 0:
        run.numbers.update(compare(ref, losses, grad1, delta))
