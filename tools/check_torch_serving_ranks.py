#!/usr/bin/env python3
"""Serving over a 'model' axis of ranks (tensor-parallel generation, the
serve and evaluation CLIs), held against one process:

    python tools/check_torch_serving_ranks.py [--model 2] [--device cuda|cpu]
        [--width small|flagship] [--logit_tol X] [--timeout 600]

It spawns `--model` processes, each given torchrun's environment, that
join one group at tcp://localhost:<a free port> (`multihost.init_from_env`:
gloo on the CPU or when the ranks share a card, NCCL when each has its
own) and run a list of jobs in one order:

* ("generate", cases): for each case (the cache dtype, the weight dtype,
  a planted fault) every rank builds its block of one canonical state dict
  (`cli.build.serving_model`: cast, quantized for fp8, then split) and runs
  `Generator.generate_batch` on the same prompts (greedy, window logits)
  and `predict_text`; each rank records its tokens, logits, the heads its
  prefill (#1) and decode (#14) attention saw, and the kernels' launches.
  With "warm" each case runs once untimed first.
  FAULTS: "scales per shard" quantizes a rank's shards after the split (a
  row-parallel c_proj then gets other scales than the whole weight's).
* ("serve", argv, requests): `python -m neko_tpu_torch.cli.serve <argv>
  --mesh_model_axis N`: rank 0 starts the server and posts the requests
  ((path, payload) pairs) one after another, then closes it; the other
  ranks run the `Follower` until then.  Each rank counts its kernels'
  launches.  Options: "idle" seconds rank 0 leaves the server without a
  request before the first, with the default group's timeout cut to
  "group_timeout" seconds for the job (a follower that waited for calls on
  that group would be ended by it); SERVE_FAULTS: "follower raises" makes
  rank 1's `generate_batch` raise after its collectives (rank 0's server
  must stop naming the fault, and the follower raise it).
* ("evaluate", argv): `python -m neko_tpu_torch.cli.evaluate <argv>
  --mesh_model_axis N` on every rank: the logs and what each rank printed.

`run_ranks(jobs, ...)` returns rank 0's results with every rank's tokens,
and the largest difference of any rank's logits from rank 0's (0: the
ranks gathered the same bits).  `main` runs one generate job (native, the
int8 cache, fp8 weights; each case warmed up first) at the CPU tests'
width (`small`, fp32) or the flagship's (768d / 6 layers / 24 heads, k =
1024, bf16; 4 prompts of 128 random tokens, 16 new), then a serve job
(the serve CLI at that width with the int8 cache, fp8 weights and an
engine of 4 slots: an engine request and a coalesced one after `--idle`
seconds without requests), then the generate cases in this process on the
same device, and prints one JSON line: rank 0's first-step logits against
one process's, the tokens the two share, every rank's generate_batch
seconds (the card synchronised) and the one process's, the serve replies'
codes and the calls the followers replayed; exit 0 when every rank agrees
with rank 0, the logits lie within `--logit_tol` (default 1e-4 small,
0.06 flagship: chip_smoke.py's TP_LOGIT_TOL) and every reply is a 200.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from check_torch_parallel_ranks import _free_port, _spawn  # noqa: E402

FAULTS = ("scales per shard",)
SERVE_FAULTS = ("follower raises",)
# the CPU tests' width (neko_tpu's tests/test_tp_serving.py)
SMALL = dict(embed_dim=64, layers=2, heads=4, dropout=0.0, context_len=64, max_patches=0,
             dtype="float32", text_tokens=128, continuous_tokens=64, discrete_tokens=64)
FLAGSHIP = dict(embed_dim=768, layers=6, heads=24, dropout=0.0, context_len=1024,
                max_patches=0, dtype="bfloat16")


def attention_recorder():
    """Patches the model's prefill and decode attention dispatch to record
    the heads of each call: -> (context manager, {"prefill": [...],
    "decode": [...]})."""
    from neko_tpu_torch.ops import attention as attn_ops

    seen = {"prefill": [], "decode": []}
    names = {"prefill_attention": "prefill", "decode_attention": "decode",
             "decode_attention_int8": "decode"}
    originals = {n: getattr(attn_ops, n) for n in names}

    def wrap(name):
        def call(q, *a, **kw):
            seen[names[name]].append(int(q.shape[1]))
            return originals[name](q, *a, **kw)
        return call

    @contextlib.contextmanager
    def patched():
        for n in names:
            setattr(attn_ops, n, wrap(n))
        try:
            yield
        finally:
            for n, fn in originals.items():
                setattr(attn_ops, n, fn)

    return patched(), seen


def launch_counters():
    from neko_tpu_torch.ops import attention_kernel, decode_attention

    return {"whole_head_attention": attention_kernel.whole_head_attention,
            "decode_cache_attention": decode_attention.decode_cache_attention,
            "decode_cache_attention_int8": decode_attention.decode_cache_attention_int8}


def build(cfg, sd, device, mesh, case):
    """This rank's Generator of a case (canonical `sd`)."""
    from neko_tpu_torch.cli.build import serving_model
    from neko_tpu_torch.convert import assign_state, build_model
    from neko_tpu_torch.inference import quant
    from neko_tpu_torch.inference.generator import Generator

    cfg = cfg.replace(kv_cache_dtype=case.get("kv", "native"))
    weights = case.get("weights")
    if case.get("fault") == "scales per shard":  # split, then quantize each shard
        model = build_model(cfg, quant.serve_cast_state_dict(sd, cfg.activation_dtype),
                            device, mesh)
        assign_state(model, quant.quantize_state_dict(model.state_dict()))
    elif case.get("fault"):
        raise ValueError(f"unknown fault {case['fault']!r}; one of {FAULTS}")
    else:
        model = serving_model(cfg, sd, device, mesh, weights)
    return Generator(model, seed=0, weight_dtype=weights)


def generate_case(gen, job):
    """generate_batch and predict_text of a job on one Generator:
    {"tokens", "logits", "text", "heads", "launches"}."""
    import torch

    ts = gen.cfg.token_space
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    recording, seen = attention_recorder()
    with recording:
        t0 = time.perf_counter()
        toks, logits = gen.generate_batch(
            [{"text": p} for p in job["prompts"]], max_new_tokens=job["new"],
            start=ts.start("text"), end=ts.end("text"))
        seconds = time.perf_counter() - t0  # the tokens are read back: the work is done
        _, text = gen.predict_text({"text": job["prompts"][0]}, max_length=job["new"])
    if gen.device.type == "cuda":
        torch.cuda.synchronize(gen.device)
    return {"tokens": toks.tolist(), "logits": logits, "text": text.tolist(), "seconds": seconds,
            "heads": {k: sorted(set(v)) for k, v in seen.items()},
            "launches": {k: fn.launches for k, fn in counters.items()}}


def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


@contextlib.contextmanager
def _group_timeout(seconds):
    """The default group's collectives give up after `seconds` inside."""
    import datetime

    import torch.distributed as dist
    from torch.distributed import constants
    from torch.distributed.distributed_c10d import _set_pg_timeout

    if seconds is None:
        yield
        return
    default = (constants.default_pg_nccl_timeout if dist.get_backend() == "nccl"
               else constants.default_pg_timeout)
    _set_pg_timeout(datetime.timedelta(seconds=seconds))
    try:
        yield
    finally:
        _set_pg_timeout(default)


def _serve(rank, job, world):
    from neko_tpu_torch.cli import serve as cli_serve
    from neko_tpu_torch.serving.server import LockstepError

    fault = job.get("fault")
    if fault is not None and fault not in SERVE_FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {SERVE_FAULTS}")
    argv = list(job["argv"]) + ["--mesh_model_axis", str(world), "--port", "0"]
    with _group_timeout(job.get("group_timeout")):
        server = cli_serve.build_server(cli_serve.parser().parse_args(argv))
        if rank > 0:
            if fault == "follower raises" and rank == 1:
                run = server.gen.generate_batch

                def generate_batch(*a, **kw):
                    run(*a, **kw)
                    raise RuntimeError("planted: generate_batch failed on rank 1 alone")

                server.gen.generate_batch = generate_batch
            try:
                server.run()
                stopped = None
            except LockstepError as err:
                stopped = str(err)
            return {"follower_calls": server.calls, "follower_errors": server.errors,
                    "follower_fault": stopped}
        server.start()
        try:
            base = f"http://{server.address[0]}:{server.address[1]}"
            time.sleep(job.get("idle", 0))
            replies = [_post(base, path, payload) for path, payload in job["requests"]]
            metrics = None
            if server.fault is None:
                with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                    metrics = json.loads(r.read())
        finally:
            server.close()
    return {"replies": replies, "metrics": metrics, "fault": server.fault}


def _evaluate(job, world):
    from neko_tpu_torch.cli import evaluate as cli_evaluate

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        logs = cli_evaluate.main(list(job["argv"]) + ["--mesh_model_axis", str(world)])
    return {"logs": logs, "printed": out.getvalue()}


def _worker(rank, world, jobs, state_path, cfg_dict, cpu, port, outdir):
    import torch

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.parallel import multihost as mh
    from neko_tpu_torch.parallel.mesh import create_mesh

    with contextlib.redirect_stdout(io.StringIO()):  # the join's own line
        device = mh.init_from_env(cpu=cpu, flag="the serving check")
    try:
        mesh = create_mesh(model=world)
        sd = torch.load(state_path, map_location="cpu", weights_only=True) if state_path else None
        cfg = ModelConfig(**cfg_dict) if cfg_dict else None
        results = []
        for job in jobs:
            if job["kind"] == "generate":
                res = []
                for case in job["cases"]:
                    gen = build(cfg, sd, device, mesh, case)
                    if job.get("warm"):
                        generate_case(gen, job)
                    r = generate_case(gen, job)
                    np.save(os.path.join(outdir, f"logits_{len(results)}_{len(res)}_{rank}.npy"),
                            r.pop("logits"))
                    res.append(r)
                results.append(res)
            else:
                counters = launch_counters()
                for fn in counters.values():
                    fn.launches = 0
                run = _serve(rank, job, world) if job["kind"] == "serve" else _evaluate(job, world)
                run["launches"] = {k: fn.launches for k, fn in counters.items()}
                results.append(run)
            dist.barrier()
        with open(os.path.join(outdir, f"rank_{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def run_ranks(jobs, *, world=2, state=None, cfg=None, device="cuda", timeout=600.0):
    """The jobs in one spawn of `world` ranks (`state`: a torch file of the
    canonical state dict and `cfg` a ModelConfig dict, for "generate").
    -> one result a job: for "generate" a list a case of rank 0's readings
    with "logits" (numpy), "rank_tokens" (every rank's) and
    "rank_logit_diff"; for "serve" rank 0's replies and metrics with the
    followers' call counts; for "evaluate" every rank's logs and print."""
    with tempfile.TemporaryDirectory() as outdir:
        _spawn(_worker, (world, list(jobs), state, cfg, device == "cpu", _free_port(), outdir),
               world, timeout)
        per_rank = []
        for r in range(world):
            with open(os.path.join(outdir, f"rank_{r}.json")) as f:
                per_rank.append(json.load(f))
        out = []
        for i, job in enumerate(jobs):
            if job["kind"] == "generate":
                cases = []
                for c in range(len(job["cases"])):
                    logits = [np.load(os.path.join(outdir, f"logits_{i}_{c}_{r}.npy"))
                              for r in range(world)]
                    res = dict(per_rank[0][i][c], logits=logits[0],
                               rank_tokens=[per_rank[r][i][c]["tokens"] for r in range(world)],
                               rank_launches=[per_rank[r][i][c]["launches"]
                                              for r in range(world)],
                               rank_seconds=[per_rank[r][i][c]["seconds"]
                                             for r in range(world)],
                               rank_logit_diff=max(float(np.abs(x - logits[0]).max())
                                                   for x in logits))
                    cases.append(res)
                out.append(cases)
            elif job["kind"] == "serve":
                out.append(dict(per_rank[0][i],
                                followers=[per_rank[r][i] for r in range(1, world)]))
            else:
                out.append([per_rank[r][i] for r in range(world)])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ranks and the one-process run go: the card unless "
                         "'cpu' is given")
    ap.add_argument("--width", default="small", choices=["small", "flagship"])
    ap.add_argument("--logit_tol", type=float, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--idle", type=float, default=2.0,
                    help="seconds the served ranks stand without a request first")
    args = ap.parse_args(argv)
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import init_state_dict

    if args.device == "cuda" and not torch.cuda.is_available():
        print("check_torch_serving_ranks: no CUDA device is visible (pass --device cpu to run "
              "the ranks on the CPU)", file=sys.stderr)
        return 2
    width = SMALL if args.width == "small" else FLAGSHIP
    tol = args.logit_tol if args.logit_tol is not None else (
        1e-4 if args.width == "small" else 0.06)
    cfg = ModelConfig(**width)
    if args.width == "small":
        prompts, new = [[5, 17, 99, 3], [88, 2, 41]], 10
    else:
        rng = np.random.RandomState(0)
        prompts = [[int(t) for t in rng.randint(1, cfg.text_tokens, 128)] for _ in range(4)]
        new = 16
    job = {"kind": "generate", "prompts": prompts, "new": new, "warm": True,
           "cases": [{}, {"kv": "int8"}, {"weights": "fp8"}]}
    serve = ["--random_init", "--seed", "0", "--kv_cache_dtype", "int8",
             "--serve_weight_dtype", "fp8", "--continuous_slots", "4"]
    serve += [f"--{k}={v}" for k, v in width.items() if k != "dropout"]
    serve += ["--cpu"] if args.device == "cpu" else []
    served = {"kind": "serve", "argv": serve, "idle": args.idle, "requests": [
        ("/v1/generate", {"text": prompts[0], "max_new_tokens": new}),               # engine
        ("/v1/generate", {"text": prompts[1], "max_new_tokens": new, "top_k": 3})]}  # coalesced
    sd = init_state_dict(cfg, 0)
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.pt")
        torch.save(sd, state)
        res, srv = run_ranks([job, served], world=args.model, state=state, cfg=width,
                             device=args.device, timeout=args.timeout)
    device = torch.device(args.device)
    one = []
    for case in job["cases"]:  # one process, the same device
        generate_case(build(cfg, sd, device, None, case), job)  # warm-up
        one.append(generate_case(build(cfg, sd, device, None, case), job))
    first = [float(np.abs(r["logits"][:, 0] - o["logits"][:, 0]).max()) for r, o in zip(res, one)]
    shared = [float(np.mean(np.array(r["tokens"]) == np.array(o["tokens"])))
              for r, o in zip(res, one)]
    codes = [code for code, _ in srv["replies"]]
    ok = all(len({json.dumps(t) for t in r["rank_tokens"]}) == 1 and r["rank_logit_diff"] == 0
             for r in res) and max(first) <= tol and codes == [200] * len(codes)
    card = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    print(json.dumps({"model": args.model, "width": args.width, "device": card,
                      "cases": job["cases"], "tokens": [r["tokens"] for r in res],
                      "heads": [r["heads"] for r in res],
                      "rank_logit_diff": [r["rank_logit_diff"] for r in res],
                      "first_logit_diff": first, "token_share": shared, "logit_tol": tol,
                      "seconds": [r["rank_seconds"] for r in res],
                      "one_process_seconds": [o["seconds"] for o in one],
                      "serve_codes": codes, "serve_fault": srv["fault"],
                      "follower_calls": [f["follower_calls"] for f in srv["followers"]],
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
