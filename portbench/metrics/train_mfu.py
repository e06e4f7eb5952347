"""train_mfu: model FLOPs of the window's steps outside the profiler
capture (portbench/flops.py train_flops_per_token, PaLM's convention, no
recompute) over the dense bf16 peak of the chips used, in percent."""

from portbench import flops


def read(run):
    r = run.readings
    peak, _ = flops.peaks(run.device_name)
    if peak is None or not r.get("main_steps"):
        return None
    work = r["main_steps"] * r["tokens_per_step"] * r.get("ranks", 1) * r["flops_per_token"]
    return 100.0 * work / (peak * run.chips * r["main_s"])
