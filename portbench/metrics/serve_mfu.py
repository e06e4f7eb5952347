"""serve_mfu: forward FLOPs of the window's completed requests (each
prompt prefilled with its head row, then a decode step for each served
token but the first; portbench/flops.py forward_flops) over the dense bf16
peak, in percent."""

from portbench import flops


def read(run):
    r = run.readings
    peak, _ = flops.peaks(run.device_name)
    if not r.get("serve") or peak is None or not r["served_flops"]:
        return None
    return 100.0 * r["served_flops"] / (peak * run.chips * r["window_s"])
