"""train_loss_roofline: kernel #15 (fused_logz_tl, the loss head's
log-sum-exp and target logit) in the capture: the least time its calls
need (portbench/flops.py loss_head: the valid gathered rows over the valid
vocabulary, in chunks of 4,096 rows as the loss calls it) over its device
time, in percent."""

from portbench import flops

CHUNK = 4096


def read(run):
    cap, r = run.capture, run.readings
    pf, pb = flops.peaks(run.device_name)
    if cap is None or pf is None or not r.get("capture_steps"):
        return None
    t = cap.kernel_s("fused_logz_tl")
    if t <= 0:
        return None
    bound = 0.0
    for i in range(0, r["loss_rows"], CHUNK):
        n = min(CHUNK, r["loss_rows"] - i)
        valid = max(0, min(n, r["targets"] - i))
        bound += flops.roofline_s(*flops.loss_head(n, valid, r["dim"], r["vocab"]), pf, pb)
    return 100.0 * bound * r["capture_steps"] / t
