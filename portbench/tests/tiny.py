"""Tiny versions of the cells' configurations and traffic for CPU tests:
the cells' own files with the widths, depth and loads cut so that a run
takes seconds on the CPU."""

import json
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def load(rel: str) -> dict:
    with open(HERE / rel) as f:
        return json.load(f)


def model(config: str) -> dict:
    c = load(f"configs/{config}.json")
    c["model"].update(embed_dim=32, layers=2, heads=2, context_len=64)
    return c


def train_mix() -> dict:
    t = load("traffic/train-mix.json")
    t.update(text_len=63, continuous={"timesteps": 5, "obs_dim": 8, "act_dim": 2},
             image={"timesteps": 10, "height": 16, "width": 16, "actions": 18},
             reference_rows_per_block=2, capture_steps=1)
    return t


def serve_mix() -> dict:
    t = load("traffic/serve-long-prompt.json")
    t.update(clients=8, slots=4, chunk=4, prompt={"median": 20, "sigma": 0.5, "min": 8},
             want={"min": 2, "max": 6}, pool=64, warm_s=1.0, drain_s=10, check_requests=4)
    return t


def run_train(workload="gato-79m.train-mix", seed=2 ** 31 + 5, seconds=1.0):
    """A tiny run of a training cell on the CPU -> harness.Run (the cell's
    own limits)."""
    from portbench import harness
    from portbench.cells import train

    bench = harness.benchmark()
    cell, _, _, limits = harness.cell_files(bench, workload)
    run = harness.Run(workload, seed, seconds, False, time.monotonic())
    run.limits = limits
    train.run(run, model(cell["config"]), train_mix(), seed, seconds, False, device="cpu",
              rows=6)
    return run


def run_serve(workload="gato-364m.serve-long-prompt", seed=2 ** 31 + 7, seconds=2.0):
    from portbench import harness
    from portbench.cells import serve

    bench = harness.benchmark()
    cell, _, _, limits = harness.cell_files(bench, workload)
    run = harness.Run(workload, seed, seconds, False, time.monotonic())
    run.limits = limits
    serve.run(run, model(cell["config"]), serve_mix(), seed, seconds, False, device="cpu")
    return run
