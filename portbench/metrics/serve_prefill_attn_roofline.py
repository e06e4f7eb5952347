"""serve_prefill_attn_roofline: kernel #1 (attention_fwd_kernel, the
admission prefill's causal attention) in the capture: the least time its
launches need (portbench/flops.py attn_fwd over each admitted prompt's
packed length; the prompts of the admissions that started in the capture,
a launch taking their mean a layer) over their device time, in percent."""

from portbench import flops


def read(run):
    cap, r = run.capture, run.readings
    pf, pb = flops.peaks(run.device_name)
    if cap is None or pf is None or not r.get("serve"):
        return None
    per_call = r.get("admit_calls_in_capture") or []
    launches = cap.count("attention_fwd_kernel")
    t = cap.kernel_s("attention_fwd_kernel")
    if not per_call or not launches or t <= 0:
        return None
    D, L, H, _ = r["dims"]
    # each call launches the kernel once a layer
    bound = sum(flops.roofline_s(*flops.attn_fwd(ls, H, D // H, max(ls)), pf, pb)
                for ls in per_call) / len(per_call)
    return 100.0 * bound * launches / t
