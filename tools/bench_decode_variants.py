#!/usr/bin/env python3
"""Times variants of the decode kernel #14 (`csrc/decode_attention.cu`) on
one card, for the choices its design makes: the ring's depth, the tile's
rows, the cluster size n, and a cluster launch where n = 1.

    python tools/bench_decode_variants.py [--splits 1 2 4 8]

Each variant is the source with one or two of its constants replaced,
built with nvcc beside the others (one process a source, all at once) into
`neko_tpu_torch/_build/variants/`, and called through the wrapper's
argument struct at a forced cluster size.  For each of the shapes of
`tools/time_attention_kernels.py --decode` (bf16 queries, a full cache,
bf16 or int8 rows) it prints one JSON line: device ms from torch.profiler
(each call on the next of enough cache copies to exceed the 50 MB L2
twice) of every (variant, n) and of every variant on empty
windows (start = end: the launch and the fixed costs alone), and the card
(nvidia-smi name and power limit).  Every variant's output is held against
the plain version first (bf16 tolerance).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# name -> {text in the source: its replacement}
VARIANTS = {
    "2 stages (as built)": {},
    "3 stages": {"kStages = 2;": "kStages = 3;"},
    "4 stages": {"kStages = 2;": "kStages = 4;"},
    "2 stages, tiles of 2x rows": {"kUnroll = 2;": "kUnroll = 4;"},
    "cluster launch at n = 1": {"cfg.numAttrs = a.n_split > 1 ? 1 : 0;": "cfg.numAttrs = 1;"},
}


def build(name: str, subs: dict, out: Path) -> Path:
    from neko_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "decode_attention.cu").read_text()
    for old, new in subs.items():
        if old not in src:
            raise SystemExit(f"variant {name!r}: {old!r} is not in the source")
        src = src.replace(old, new)
    stem = "".join(c if c.isalnum() else "_" for c in name)
    cu, so = out / f"{stem}.cu", out / f"{stem}.so"
    cu.write_text(src)
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name!r} failed to build:\n{proc.stderr[-3000:]}")
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_decode_variants: no CUDA device is visible", file=sys.stderr)
        return 2
    from neko_tpu_torch.bench import card
    from neko_tpu_torch.ops import cuda_build
    from neko_tpu_torch.ops import decode_attention as da
    from tools.time_attention_kernels import DECODE_SHAPES, _device_ms

    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {name: pool.submit(build, name, subs, out) for name, subs in VARIANTS.items()}
        libs = {name: ctypes.CDLL(str(f.result())) for name, f in futures.items()}
    for lib in libs.values():
        lib.decode_cache_attention.argtypes = [ctypes.POINTER(da._Args), ctypes.c_void_p]
        lib.decode_cache_attention.restype = ctypes.c_int

    def call(lib, n, q, k, v, scales, start, end, mask):
        B, H, S, hd = k.shape
        o = torch.empty(B, H, hd, dtype=q.dtype, device=q.device)
        none = da._View(None, 0, 0, 0)
        ks, vs = (none, none) if scales is None else (da._view(t) for t in scales)
        a = da._Args(q=da._view(q), k=da._view(k), v=da._view(v), o=da._view(o),
                     start=start.data_ptr(), end=end.data_ptr(), mask=mask.data_ptr(),
                     mask_sb=mask.stride(0), B=B, H=H, S=S, D=hd, dtype=1,
                     sm_scale=hd ** -0.5, int8_cache=int(scales is not None), ks=ks, vs=vs,
                     n_split=n)
        err = lib.decode_cache_attention(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError_t {err} (n={n})")
        return o

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for cache, B, H, S, hd in DECODE_SHAPES:
        int8 = cache == "int8"
        q = torch.randn(B, H, hd, device=dev, generator=g).bfloat16()
        row = hd + 4 if int8 else 2 * hd
        copies = -(-100_000_000 // (2 * B * H * S * row))
        def cache_copy():  # (k, v, scales or None)
            k, v = (torch.randn(B, H, S, hd, device=dev, generator=g) for _ in range(2))
            if not int8:
                return k.bfloat16(), v.bfloat16(), None
            (kq, ks), (vq, vs) = da.quant_rows(k), da.quant_rows(v)
            return kq, vq, (ks, vs)

        caches = [cache_copy() for _ in range(copies)]
        turn = itertools.cycle(caches)
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        end = torch.full((B,), S, dtype=torch.int32, device=dev)
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        k0, v0, s0 = caches[0]
        want = (da.decode_cache_attention_reference(q, k0, v0, start, end) if not int8 else
                da.decode_cache_attention_int8_reference(q, k0, s0[0], v0, s0[1], start, end))
        row_ms = {}
        for name, lib in libs.items():
            for n in args.splits:
                got = call(lib, n, q, k0, v0, s0, start, end, valid)
                torch.cuda.synchronize()
                if not torch.allclose(got.float(), want.float(), atol=1e-2, rtol=2.0 ** -7):
                    raise SystemExit(f"variant {name!r} at n={n} disagrees with the plain version")
                row_ms[f"{name}, n={n}"] = _device_ms(
                    lambda: call(lib, n, q, *next(turn), start, end, valid))
            row_ms[f"{name}, empty windows, n=1"] = _device_ms(
                lambda: call(lib, 1, q, *next(turn), start, start, valid))
        del caches
        print(json.dumps({"shape": f"{cache} {B},{H},{S},{hd}", "card": card(), "ms": row_ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
