"""The harness: finds a cell's configuration, traffic and metrics by the
names in BENCHMARK.json, runs the cell's runner, reads the metrics and
prints the result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A configuration is `portbench/configs/<config>.json`, a traffic mix
`portbench/traffic/<traffic>.json` (its "generator" names the runner in
`portbench/cells/`), a metric `portbench/metrics/<metric>.py` (a `read(run)`
that returns a number, or None where it finds nothing to read), and the
limits of a cell's checks `portbench/limits/<workload>.json`."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "neko_tpu")
RUNNERS = {"train_rows": "portbench.cells.train", "closed_loop": "portbench.cells.serve"}


class Run:
    """One run of a cell: what the runner read, for the metric readers."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, t_start: float):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.t_start = t_start
        self.window_start: Optional[float] = None
        self.memory_peak = 0
        self.attempted = self.failed = 0
        self.readings: Dict = {}
        self.numbers: Dict[str, float] = {}
        self.capture = None
        self.device_name = ""
        self.chips = 1
        self.limits: Dict[str, float] = {}

    @property
    def setup_s(self) -> float:
        return self.window_start - self.t_start

    def checks(self) -> Dict[str, Dict[str, float]]:
        return {n: {"value": v, "limit": self.limits.get(n)} for n, v in self.numbers.items()}

    def correct(self) -> bool:
        if not self.numbers or self.failed:
            return False
        return all(n in self.limits and math.isfinite(v) and v <= self.limits[n]
                   for n, v in self.numbers.items())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(bench: dict, workload: str):
    """(cell entry, configuration, traffic, limits) of `workload`."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    lim = HERE / "limits" / f"{workload}.json"
    limits = load_json(lim)["limits"] if lim.exists() else {}
    return cell, config, traffic, limits


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, workload: str, trace: bool):
    """The metric entries a run of `workload` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metrics(bench: dict, run: Run) -> Dict[str, Dict]:
    out = {}
    for m in metrics_of(bench, run.workload, run.trace):
        v = metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card() -> str:
    """'name, power limit' as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unreadable"


def banned_modules():
    return sorted({n.split(".")[0] for n in sys.modules} & set(BANNED))


def execute(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda", config=None, traffic=None,
            rows=None) -> Run:
    """Run the cell's runner (no look for a chip: `main` does that);
    `config`, `traffic` and `rows` replace the cell's (tests at a tiny
    size)."""
    cell, config0, traffic0, limits = cell_files(bench, workload)
    config, traffic = config or config0, traffic or traffic0
    run = Run(workload, seed, seconds, trace, t_start)
    run.limits, run.chips = limits, cell["chips"]
    runner = importlib.import_module(RUNNERS[traffic["generator"]])
    kw = {"rows": rows} if rows else {}
    runner.run(run, config, traffic, seed, seconds, trace, device=device, **kw)
    return run


def result_line(bench: dict, run: Run) -> Dict:
    out = {"correct": run.correct(), "attempted": run.attempted, "failed": run.failed,
           "metrics": read_metrics(bench, run),
           "device": {"platform": "gpu", "kind": run.device_name, "count": run.chips,
                      "memory_peak_bytes": int(run.memory_peak)}}
    if run.capture is not None:
        out["device"]["busy_s"] = run.readings.get("busy_s", run.capture.busy_s)
        out["device"]["window_s"] = run.capture.window_s
        out["breakdown"] = run.capture.breakdown()
    out["card"] = run.readings.get("card", "")
    out["checks"] = run.checks()
    return out


def over_ranks(argv, world: int, args, t_start: float) -> Run:
    """Rank 0 here, ranks 1.. in processes of their own (portbench/ranks.py),
    each on its own card; every rank has ended when this returns."""
    from portbench import ranks

    port = ranks.free_port()
    procs = [ranks.spawn(argv, r, world, port) for r in range(1, world)]
    try:
        run = ranks.run_rank(0, world, port, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start)
        for p in procs:
            if p.wait(timeout=300) != 0:
                raise RuntimeError(f"a rank exited with {p.returncode}")
        return run
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import neko_tpu_torch
    import torch

    if Path(neko_tpu_torch.__file__).resolve().parent != ROOT / "neko_tpu_torch":
        print(f"portbench: neko_tpu_torch comes from {neko_tpu_torch.__file__}, not from "
              f"this checkout", file=sys.stderr)
        return 2
    bench = benchmark()
    cell = cell_files(bench, args.workload)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell["chips"] > 1:
        run = over_ranks(argv, cell["chips"], args, t_start)
    else:
        run = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    run.device_name = torch.cuda.get_device_name(0)
    run.readings["card"] = card()
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(bench, run)
    print(f"card: {line['card']}", file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
