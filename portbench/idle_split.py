"""A serving cell's capture read through the program's own spans
(`neko_tpu_torch.utils.trace`): the device-idle time split by the engine
thread's innermost span, the queue wait of the requests admitted during
the capture, and how far the program's spans lie from the device work they
launched on the capture's timeline.

    python3 portbench/idle_split.py --workload gato-364m.serve-long-prompt --seed <n>

runs the cell with `--trace 1` as portbench/run.py does (a CUDA device
needed) and prints one JSON line: the per-layer metrics, `idle_s` (seconds
of idle device by the engine thread's innermost span, "none" outside every
span), `queue_wait_s` (p50 and p95 of the engine.queue spans that ended in
the capture), `prefill_lag_us` (for each admit.prefill span, its mapped
start less the end of the idle gap before its first device work: > 0 where
the spans map later than the device events) and `decode_step_ms` (the
count, quartiles and mean of the capture's decode.step spans)."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

T_START = time.monotonic()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.program_spans import captured  # noqa: E402

# the engine thread's spans; engine.queue is recorded there too but covers
# a request's wait in the queue, not what the thread did
ENGINE = ("engine.admit", "admit.pack", "admit.prefill", "admit.install", "engine.chunk",
          "decode.step", "spec.round", "chunk.fetch", "engine.bookkeep")


def idle_by_span(run) -> dict:
    """Seconds of the capture's idle gaps by the innermost ENGINE span over
    each part of them."""
    spans = [(a, b, s.name) for s, a, b in captured(run, *ENGINE) or ()]
    out = {}
    for g0, g1 in run.capture.gaps:
        cuts = sorted({g0, g1} | {x for a, b, _ in spans for x in (a, b) if g0 < x < g1})
        for a, b in zip(cuts, cuts[1:]):
            m = (a + b) / 2
            inside = [(y - x, n) for x, y, n in spans if x <= m < y]
            name = min(inside)[1] if inside else "none"
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def prefill_lag_us(run, near_us: float = 5000.0) -> list:
    """For each admit.prefill span: its mapped start less the end of the
    longest idle gap that ends within `near_us` of it (the device idles
    while the engine packs the prompts, so that end is the prefill's first
    device work; the prefill's own gaps are shorter)."""
    lags = []
    for _, a, _ in sorted(captured(run, "admit.prefill") or (), key=lambda x: x[1]):
        near = [(g1 - g0, g1) for g0, g1 in run.capture.gaps if abs(g1 - a) <= near_us]
        if near:
            lags.append(a - max(near)[1])
    return lags


def queue_waits(run) -> dict:
    from neko_tpu_torch.utils import trace

    cap = run.capture
    w = sorted(s.seconds for s in trace.spans(cap.host0 - 600.0, cap.host1)
               if s.name == "engine.queue" and cap.host0 <= s.t1 < cap.host1)
    if not w:
        return {}
    p95 = w[-(-95 * len(w) // 100) - 1]  # nearest rank
    return {"n": len(w), "p50": statistics.median(w), "p95": p95}


def decode_steps_ms(run) -> dict:
    ms = sorted(1e3 * s.seconds for s, _, _ in captured(run, "decode.step") or ())
    if len(ms) < 2:
        return {}
    q1, q2, q3 = statistics.quantiles(ms, n=4)
    return {"n": len(ms), "q1": q1, "p50": q2, "q3": q3, "mean": statistics.fmean(ms),
            "max": ms[-1]}


def main(argv) -> int:
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="gato-364m.serve-long-prompt")
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("idle_split: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    bench = harness.benchmark()
    run = harness.execute(bench, args.workload, args.seed, bench["run_seconds"], True, T_START)
    line = harness.result_line(bench, run)
    print(json.dumps({
        "correct": line["correct"], "card": harness.card(),
        "metrics": {k: v["value"] for k, v in line["metrics"].items()},
        "window_s": run.capture.window_s, "busy_s": run.capture.busy_s,
        "idle_s": idle_by_span(run), "queue_wait_s": queue_waits(run),
        "prefill_lag_us": prefill_lag_us(run), "decode_step_ms": decode_steps_ms(run)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
