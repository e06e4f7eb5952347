"""The ranks of a cell over several chips: one process a chip, a
torch.distributed group over TCP on 127.0.0.1 (NCCL between cards, gloo on
the CPU).  Rank 0 is the process that prints the result line; it starts
the others with `spawn` and waits for each to end.

    python3 portbench/ranks.py --rank R --world N --port P --workload W --seed S
        --seconds T --trace X [--backend gloo --device cpu --config JSON
        --traffic JSON --rows N]

runs one rank other than 0 (its output is rank 0's to read: it prints the
JSON of its readings only when it is rank 0)."""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HERE = Path(__file__).resolve()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, rank: int, world: int, port: int, extra=()) -> subprocess.Popen:
    """Start rank `rank` (> 0) with the run's arguments `argv`."""
    return subprocess.Popen(
        [sys.executable, str(HERE), "--rank", str(rank), "--world", str(world), "--port",
         str(port), *argv, *extra], stdout=subprocess.DEVNULL, env=dict(os.environ))


def run_rank(rank: int, world: int, port: int, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, backend: str = "nccl", device: str = "cuda",
             config=None, traffic=None, rows=None):
    """This rank's part of a run -> its harness.Run."""
    import torch
    import torch.distributed as dist

    from portbench import harness

    if device == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=600))
    try:
        return harness.execute(harness.benchmark(), workload, seed, seconds, trace, t_start,
                               device, config=config, traffic=traffic, rows=rows)
    finally:
        dist.destroy_process_group()


def main() -> int:
    t_start = time.monotonic()
    ap = argparse.ArgumentParser()
    for a in ("--rank", "--world", "--port", "--seed", "--trace"):
        ap.add_argument(a, type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--rows", type=int)
    a = ap.parse_args()
    load = lambda s: None if s is None else json.loads(s)  # noqa: E731
    run = run_rank(a.rank, a.world, a.port, a.workload, a.seed, a.seconds, bool(a.trace),
                   t_start, a.backend, a.device, load(a.config), load(a.traffic), a.rows)
    if a.rank == 0:
        print(json.dumps({"numbers": run.numbers, "correct": run.correct(),
                          "attempted": run.attempted, "readings": {
                              k: v for k, v in run.readings.items()
                              if isinstance(v, (int, float, str))}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
