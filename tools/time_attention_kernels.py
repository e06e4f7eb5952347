#!/usr/bin/env python3
"""Times the port's attention kernels at the train path's shapes, for
comparing two checkouts on one card in one run:

    python tools/time_attention_kernels.py [--repo DIR]

imports `neko_tpu_torch` from DIR (default: this checkout), builds its
kernels into DIR's `_build/` and prints one JSON line: the card (nvidia-smi
name and power limit) and the kernel ms (CUDA events, mean of 20 calls
after 3 warm-up calls), bf16, dropout 0.1, full rows: the whole-head
forward and backward at the flagship train shape (B=16, H=24, S=1024,
hd=32), the blocked forward, fused backward, dq and dkv at `long`
(B=8, H=24, S=2048, hd=32); and, where the checkout has them, the ring's
per-pair forward, dq and dkv on a full (past) pair of the k = 8192 shards
(B=2, H=24, S_local=2048, hd=32), the prefill forward (B=8, H=24, S=1024,
hd=32, no dropout) and the decode step (B=8, H=24, S=1024, hd=32, a full
cache; device time from torch.profiler, as a call's host work outlasts the
kernel).  Run it as parent, change, change, parent.

    python tools/time_attention_kernels.py --decode [--repo DIR]

times the decode kernel #14 alone, at DECODE_SHAPES (bf16 and int8 caches,
a full cache, bf16 queries): device ms per call from torch.profiler, each
call on the next of enough copies of the cache to exceed the 50 MB L2
twice, with the bound (bytes / 3.35 TB/s: K, V, int8 scales, q, o, mask)
and, where the checkout has `kernel_split`, the cluster size it used.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, iters: int = 50) -> float:
    """Device time per call: the kernels `fn` launched, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy / 1e3 / iters


# (cache, B, H, S, hd) timed by --decode
DECODE_SHAPES = (("bf16", 8, 24, 1024, 32), ("bf16", 1, 24, 1024, 32), ("bf16", 1, 24, 8192, 32),
                 ("bf16", 8, 24, 8192, 32), ("bf16", 8, 12, 1024, 64), ("int8", 8, 24, 1024, 32),
                 ("int8", 1, 24, 1024, 32), ("int8", 1, 24, 8192, 32))


def decode_ms(da, dev, g) -> dict:
    """{"<cache> B,H,S,hd": {"ms", "bound_ms", "n"}} at DECODE_SHAPES."""
    import itertools

    import torch

    out = {}
    for cache, B, H, S, hd in DECODE_SHAPES:
        int8 = cache == "int8"
        q = torch.randn(B, H, hd, device=dev, generator=g).bfloat16()
        row = hd + 4 if int8 else 2 * hd  # cache bytes a row of K or V (int8: and its scale)
        copies = -(-100_000_000 // (2 * B * H * S * row))
        make = (lambda: da.quant_rows(torch.randn(B, H, S, hd, device=dev, generator=g))) \
            if int8 else (lambda: (torch.randn(B, H, S, hd, device=dev, generator=g).bfloat16(),))
        caches = [[*make(), *make()] for _ in range(copies)]
        turn = itertools.cycle(caches)
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        end = torch.full((B,), S, dtype=torch.int32, device=dev)
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        if int8:
            ms = _device_ms(lambda: da.decode_cache_attention_int8(q, *next(turn), start, end,
                                                                   valid))
        else:
            ms = _device_ms(lambda: da.decode_cache_attention(q, *next(turn), start, end, valid))
        del caches
        nbytes = 2 * B * H * S * row + 2 * B * H * hd * 2 + B * S
        entry = {"ms": ms, "bound_ms": nbytes / 3.35e9}
        if hasattr(da, "kernel_split"):
            entry["n"] = da.kernel_split(q, S)
        out[f"{cache} {B},{H},{S},{hd}"] = entry
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--decode", action="store_true", help="time the decode kernel #14 alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    from neko_tpu_torch.bench import card
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import cuda_build

    dev, rate = torch.device("cuda"), 0.1
    g = torch.Generator(device=dev).manual_seed(0)
    if args.decode:
        from neko_tpu_torch.ops import decode_attention as da

        cuda_build.build("decode_attention")
        print(json.dumps({"repo": args.repo, "card": card(), "decode": decode_ms(da, dev, g)}))
        return 0
    cuda_build.build_all()
    seed = torch.tensor([7], dtype=torch.int32, device=dev)
    ms = {}

    def views(B, H, S, hd):
        qkv = torch.randn(B, S, 3 * H * hd, device=dev, generator=g).bfloat16()
        dout = torch.randn(B, S, H * hd, device=dev, generator=g).bfloat16()
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        end = torch.full((B,), S, dtype=torch.int32, device=dev)
        return (*whk._qkv_views("qkv", (qkv,), H), whk._heads4(dout, H), start, end)

    q, k, v, do, start, end = views(16, 24, 1024, 32)
    out, lse = whk.whole_head_attention_fwd(q, k, v, start, end, seed, None, rate, need_lse=True)
    ms["whole_head_fwd"] = _time_ms(lambda: whk.whole_head_attention_fwd(
        q, k, v, start, end, seed, None, rate, out=out, need_lse=True))
    ms["whole_head_bwd"] = _time_ms(lambda: whk.whole_head_attention_bwd(
        q, k, v, out, do, lse, start, end, seed, None, rate))

    q, k, v, do, start, end = views(8, 24, 2048, 32)
    out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, rate)
    bwd = (q, k, v, do, m, l, ba.row_delta(do, out), start, end, seed, None, rate)
    ms["blocked_fwd"] = _time_ms(lambda: ba.blocked_attention_fwd(
        q, k, v, start, end, seed, None, rate, out=out))
    ms["blocked_bwd_fused"] = _time_ms(lambda: ba.blocked_attention_bwd_fused(*bwd))
    ms["blocked_dq"] = _time_ms(lambda: ba.blocked_attention_dq(*bwd))
    ms["blocked_dkv"] = _time_ms(lambda: ba.blocked_attention_dkv(*bwd))

    try:
        from neko_tpu_torch.ops import ring_kernel as rk
    except ImportError:  # a checkout from before the ring kernels
        rk = None
    if rk is not None:
        q, k, v, do, start, end = views(2, 24, 2048, 32)
        end = end * 4  # shard 3 meets the kv block of shard 2 of an 8192-row sequence
        L = torch.full((2, 24, 2048), 8.0, device=dev)
        delta = torch.zeros_like(L)
        at = (3 * 2048, 2 * 2048, start, end, seed, None, rate)
        acc, m, l = rk.ring_partial_fwd(q, k, v, *at)
        bufs = rk._new_grads(q)
        ms["ring_fwd"] = _time_ms(lambda: rk.ring_partial_fwd(q, k, v, *at, out=acc, m=m, l=l))
        ms["ring_dq"] = _time_ms(lambda: rk.ring_partial_dq(q, k, v, do, L, delta, *at,
                                                            dq=bufs[0]))
        ms["ring_dkv"] = _time_ms(lambda: rk.ring_partial_dkv(q, k, v, do, L, delta, *at,
                                                              dk=bufs[1], dv=bufs[2]))
    try:
        from neko_tpu_torch.ops import decode_attention as da
    except ImportError:  # a checkout from before the decode kernel
        da = None
    if da is not None:
        q, k, v = (torch.randn(8, 24, 1024, 32, device=dev, generator=g).bfloat16()
                   for _ in range(3))
        start = torch.zeros(8, dtype=torch.int32, device=dev)
        end = torch.full((8,), 1024, dtype=torch.int32, device=dev)
        ms["prefill_fwd"] = _time_ms(lambda: whk.whole_head_attention_fwd(q, k, v, start, end))
        qd, mask = q[:, :, 0], torch.ones(8, 1024, dtype=torch.bool, device=dev)
        if "key_mask" in inspect.signature(da.decode_cache_attention).parameters:
            ms["decode_device"] = _device_ms(
                lambda: da.decode_cache_attention(qd, k, v, start, end, mask))
        else:
            ms["decode_device"] = _device_ms(
                lambda: da.decode_cache_attention(qd, k, v, start, end))
    print(json.dumps({"repo": args.repo, "card": card(), "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
