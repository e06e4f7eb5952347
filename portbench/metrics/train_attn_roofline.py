"""train_attn_roofline: kernels #3 and #4 (the whole-head attention forward
with dropout and its backward) in the capture: the least time their calls
need (portbench/flops.py attn_fwd / attn_bwd over each row's valid length,
against the card's peaks) over their device time, in percent."""

from portbench import flops


def read(run):
    cap, r = run.capture, run.readings
    pf, pb = flops.peaks(run.device_name)
    if cap is None or pf is None or not r.get("capture_steps"):
        return None
    calls = r["capture_steps"] * r["layers"]
    if cap.count("attention_fwd_kernel") != calls:
        return None
    args = (r["lengths"], r["heads"], r["head_dim"], r["seq"])
    bound = calls * (flops.roofline_s(*flops.attn_fwd(*args), pf, pb)
                     + flops.roofline_s(*flops.attn_bwd(*args), pf, pb))
    t = cap.kernel_s("attention_fwd_kernel", "attention_bwd_")
    return 100.0 * bound / t if t > 0 else None
