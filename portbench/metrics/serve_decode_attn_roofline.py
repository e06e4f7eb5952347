"""serve_decode_attn_roofline: kernel #14 (decode_attention_kernel, one
query a row and head over the cache) in the capture: the least time its
launches need (portbench/flops.py decode_attn over the valid cached keys,
which a device counter sums over the capture's calls, a launch taking the
mean of them) over their device time, in percent."""

from portbench import flops


def read(run):
    cap, r = run.capture, run.readings
    pf, pb = flops.peaks(run.device_name)
    if cap is None or pf is None or not r.get("serve"):
        return None
    keys, calls = r["decode_keys"]
    launches = cap.count("decode_attention_kernel")
    t = cap.kernel_s("decode_attention_kernel")
    if not calls or not launches or t <= 0:
        return None
    D, _, H, _ = r["dims"]
    f, b = flops.decode_attn(keys / calls, r["slots"], H, D // H)
    return 100.0 * launches * flops.roofline_s(f, b, pf, pb) / t
