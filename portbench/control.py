"""Readings that set a cell's limits, not part of a benchmark run:

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--seconds 5]

A training cell: per seed, the plain reference through the checked steps in
float32, then one step of precision down (float8 e4m3 products,
the control), then with half of each batch left out (the loss over the
rest: a planted fault) and, over several cards (one process a card, as
the cell runs), with the exchange of gradients between them left out;
prints the numbers the benchmark compares of the
control and of the fault against the float32 reference.  A serving cell:
per seed, a short run of the cell at its own load; the served tokens'
widest gap (the program) and, at the same prompts and tokens, the widest
gap of the tokens the float8 reference puts first (the control).  One JSON
line a seed."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def train_readings(config, t, seed, device="cuda", rows=None):
    """The control's and the planted faults' numbers against the float32
    reference (over the ranks of an initialised process group, each on its
    rows: then also the exchange between the ranks left out); rank 0's
    are the readings."""
    import torch

    from portbench.cells import train
    from portbench.generators import train_rows

    rk = train.Ranks()
    m = config["model"]
    rows = rows or train.rows_per_chip(config, t)
    pseed = train.program_seed(seed)
    bud = train_rows.budgets(t, rows, m.get("patch_size", 16))
    pools = train_rows.pools(t, m["text_tokens"], rows, seed, rk.rank)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    on = dict(rank=rk.rank, world=rk.world)
    ref = train.reference_steps(m, t, seed, pseed, rows, bud, pools, device, **on)

    def as_program(r):
        losses, g1, d = r
        return losses, {n: float(torch.linalg.vector_norm(g.double())) for n, g in g1.items()}, d

    out = {"seed": seed}
    faults = [("control_fp8", {"precision": "fp8"}), ("half_batch", {"keep_rows": rows // 2})]
    if rk.world > 1:
        faults.append(("no_exchange", {"exchange": False}))
    for name, kw in faults:
        t0 = time.monotonic()
        other = train.reference_steps(m, t, seed, pseed, rows, bud, pools, device, **on, **kw)
        out[name] = train.compare(ref, *as_program(other))
        out[name + "_s"] = time.monotonic() - t0
    return out


def serve_readings(config, t, seed, seconds, device="cuda"):
    from portbench.cells import serve

    captured = {}
    orig = serve.check

    def keep(m, t_, seed_, done, make, device_, control=False):
        captured["args"] = (m, t_, seed_, done, make, device_)
        return orig(m, t_, seed_, done, make, device_)

    serve.check = keep
    run = harness.Run("control", seed, seconds, False, time.monotonic())
    try:
        serve.run(run, config, t, seed, seconds, False, device=device)
    finally:
        serve.check = orig
    prog, ctrl = orig(*captured["args"], control=True)
    return {"seed": seed, "served_gap": prog, "control_fp8": ctrl,
            "served": len(captured["args"][3])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--port", type=int)
    a = ap.parse_args()
    cell, config, t, _ = harness.cell_files(harness.benchmark(), a.workload)
    procs = []
    if cell["chips"] > 1:  # one process a card, as the cell runs
        import datetime

        import torch
        import torch.distributed as dist

        from portbench import ranks

        if a.rank is None:
            a.rank, a.world, a.port = 0, cell["chips"], ranks.free_port()
            procs = [subprocess.Popen([sys.executable, __file__, *sys.argv[1:], "--rank", str(r),
                                       "--world", str(a.world), "--port", str(a.port)],
                                      stdout=subprocess.DEVNULL) for r in range(1, a.world)]
        torch.cuda.set_device(a.rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{a.port}",
                                world_size=a.world, rank=a.rank,
                                timeout=datetime.timedelta(seconds=600))
    device = f"cuda:{a.rank}" if procs or a.rank else "cuda"
    for seed in (int(s) for s in a.seeds.split(",")):
        if t["generator"] == "train_rows":
            out = train_readings(config, t, seed, device)
        else:
            out = serve_readings(config, t, seed, a.seconds)
        if not a.rank:
            print(json.dumps({"workload": a.workload, **out}), flush=True)
    if cell["chips"] > 1:
        dist.destroy_process_group()
    for p in procs:
        p.wait(timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
