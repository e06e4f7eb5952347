#!/usr/bin/env python3
"""Holds the process-group schedule of the port's ring attention against its
one-device schedule:

    python tools/check_torch_ring_ranks.py [--backend gloo|nccl] [--ranks 4]
        [--s_local 128] [--heads 2] [--hd 64] [--batch 2] [--rate 0.1]
        [--dtype float32|bfloat16] [--atol 1e-6] [--timeout 120]

Inputs come from a numpy seed: q, k, v, do [B, n * S_local, H * hd], a full
row and a left-padded one.  The parent computes `ring_attention_bsd` over n
shards on one device (`group=None`): out and dq, dk, dv.  Then it spawns n
processes that join one `torch.distributed` group at tcp://localhost:<a free
port>; rank r gets row block r, runs `ring_attention_bsd(..., group=WORLD)`
forward and backward -- k, v and the dk, dv sums travel from rank to rank --
and compares its out, dq, dk, dv with block r of the parent's.

`gloo` runs on CPU tensors (the kernels' plain versions); `nccl` puts rank r
on CUDA device r (the kernels) and needs as many cards as ranks.  Prints one
JSON line {"backend", "ranks", "device", "max_abs_err": {...}, "bit_equal",
"atol", "ok"} and exits 0 only when every rank agrees within `atol`.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NAMES = ("out", "dq", "dk", "dv")


def _inputs(args):
    n, S_l, D = args.ranks, args.s_local, args.heads * args.hd
    S = n * S_l
    rng = np.random.default_rng(0)
    q, k, v, do = (rng.standard_normal((args.batch, S, D)).astype(np.float32) for _ in range(4))
    start = np.array(([0, S_l + S_l // 3] * args.batch)[:args.batch], np.int32)
    end = np.full(args.batch, S, np.int32)
    do = do * (np.arange(S)[None, :] >= start[:, None])[..., None]
    return q, k, v, do.astype(np.float32), start, end


def _ring(tensors, start, end, args, device, rows, group):
    """(out, dq, dk, dv) of `ring_attention_bsd` on the row block `rows` of
    the inputs, on `device`, as float32 numpy."""
    import torch

    from neko_tpu_torch.ops import ring_kernel as rk

    dtype = getattr(torch, args.dtype)
    q, k, v, do = (torch.from_numpy(np.ascontiguousarray(t[:, rows])).to(device, dtype)
                   for t in tensors)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    seed = torch.tensor([7], dtype=torch.int32, device=device)
    out = rk.ring_attention_bsd(
        q, k, v, torch.from_numpy(start).to(device), torch.from_numpy(end).to(device), seed,
        n_shards=args.ranks, heads=args.heads, group=group, dropout_rate=args.rate)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [t.detach().float().cpu().numpy() for t in (out, *grads)]


def _worker(rank, args, port, tensors, start, end, want, errs):
    import torch
    import torch.distributed as dist

    dist.init_process_group(args.backend, init_method=f"tcp://localhost:{port}",
                            world_size=args.ranks, rank=rank)
    try:
        device = torch.device("cuda", rank) if args.backend == "nccl" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        S_l = args.s_local
        rows = slice(rank * S_l, (rank + 1) * S_l)
        got = _ring(tensors, start, end, args, device, rows, dist.group.WORLD)
        for i, (g, w) in enumerate(zip(got, want)):
            errs[rank * len(NAMES) + i] = float(np.abs(g - w[:, rows]).max())
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--s_local", type=int, default=128)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--hd", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--rate", type=float, default=0.1)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--atol", type=float, default=1e-6)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    torch.set_num_threads(1)
    if args.backend == "nccl" and torch.cuda.device_count() < args.ranks:
        print(f"check_torch_ring_ranks: nccl needs {args.ranks} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0) if args.backend == "nccl" else torch.device("cpu")
    *tensors, start, end = _inputs(args)
    want = _ring(tensors, start, end, args, device, slice(None), None)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    errs = ctx.Array("d", [float("nan")] * (args.ranks * len(NAMES)))
    procs = mp.spawn(_worker, args=(args, port, tensors, start, end, want, errs),
                     nprocs=args.ranks, join=False)
    deadline = time.monotonic() + args.timeout
    while not procs.join(timeout=1.0):  # True once every rank has ended; raises if one failed
        if time.monotonic() > deadline:  # a rank hangs: stop them all and fail
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
            print(f"check_torch_ring_ranks: no end after {args.timeout} s", file=sys.stderr)
            return 1
    per = np.array(errs[:]).reshape(args.ranks, len(NAMES))
    worst = {n: float(per[:, i].max()) for i, n in enumerate(NAMES)}
    ok = bool(np.isfinite(per).all() and per.max() <= args.atol)
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print(json.dumps({"backend": args.backend, "ranks": args.ranks, "device": name,
                      "shape": [args.batch, args.ranks * args.s_local, args.heads, args.hd],
                      "dtype": args.dtype, "rate": args.rate, "max_abs_err": worst,
                      "bit_equal": bool(per.max() == 0.0), "atol": args.atol, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
