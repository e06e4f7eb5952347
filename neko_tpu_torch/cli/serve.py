"""`python -m neko_tpu_torch.cli.serve` -- HTTP inference server (counterpart
of neko_tpu/cli/serve.py).

    python -m neko_tpu_torch.cli.serve --model_path DIR [--cpu]
        [--continuous_slots 8 [--continuous_chunk 8] [--continuous_spec_k 4]]
        [--draft_model_path DIR2 | --self_draft_layers 2]
    python -m neko_tpu_torch.cli.serve --random_init --seed 0 \\
        --embed_dim 768 --layers 6 --heads 24 --context_len 1024

DIR is a checkpoint_<N> dir written by `python -m neko_tpu_torch.cli.train`
or its experiment dir (the latest checkpoint is used): the run's args.json
is loaded, the flags given here override it, and the weights are restored
as the evaluation CLI restores them (cli/build.py).  A directory with
`model.pt` + `config.json` and no args.json beside it (what
tools/export_torch_checkpoint.py writes from a neko_tpu checkpoint) loads as
it is.  `--random_init` builds random weights from `--seed` and the
architecture flags instead, for smoke runs.  The model runs on the CUDA
device unless `--cpu` (or `--device cpu`) is given; without a card there is
no fallback.

`--continuous_slots` > 0 serves plain generate requests through the
continuous-batching engine (with token streaming); `--draft_model_path`
(restored like `--model_path`) or `--self_draft_layers N` (the target's
first N layers) loads a draft model for speculative requests.  `--use_ema`
serves the checkpoints' EMA shadows (`ema.pt`) in place of their weights.
`--kv_cache_dtype int8` keeps the KV caches as int8 rows with row scales;
`--serve_weight_dtype fp8` serves the matmul weights as e4m3 with
per-output-channel scales (inference/quant.py); the draft takes both.

Tensor-parallel serving, N ranks under torchrun:

    torchrun --nproc_per_node N -m neko_tpu_torch.cli.serve --mesh_model_axis N ...

Each rank holds its heads and its block of the MLP and the vocabulary (the
canonical weights quantized first with fp8); rank 0 answers HTTP and the
other ranks replay its Generator calls in lockstep (serving/server.py); if
the ranks' outcomes of a call differ, the server stops and the CLI exits
naming why.
NCCL carries the collectives when every rank has a card of its own, gloo
when ranks share one or with `--cpu`.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.serving.server import Follower

# architecture flags of --random_init: ModelConfig field -> type
_ARCH_FLAGS = {
    "embed_dim": int, "layers": int, "heads": int, "context_len": int,
    "text_tokens": int, "continuous_tokens": int, "discrete_tokens": int,
    "max_patches": int, "patch_size": int, "dtype": str,
}


def refuse_unported(cli) -> None:
    """The JAX package's serving option with no counterpart here: its XLA
    compile cache (a TPU artefact; the port compiles nothing at serve time
    but its kernels, once)."""
    if cli.compilation_cache is not None:
        raise NotImplementedError("not yet ported to neko_tpu_torch: ['--compilation_cache']")


def _device(cli) -> torch.device:
    device = torch.device("cpu" if cli.cpu else cli.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible (pass --cpu to serve "
                         "on the CPU)")
    return device


def _exported_model_dir(path: str) -> bool:
    """model.pt + config.json with no training run's args.json beside them."""
    parent = os.path.dirname(os.path.abspath(path))
    return (os.path.isfile(os.path.join(path, "config.json"))
            and not os.path.isfile(os.path.join(parent, "args.json")))


def load_model(cli, model_path: str, ranks=None):
    """-> (model on the command's device, this rank's shard over `ranks`'
    mesh, packer or None)."""
    from neko_tpu_torch.cli.build import build_context, load_state_for, serving_model
    from neko_tpu_torch.cli.build import resolve_checkpoint_and_args
    from neko_tpu_torch.convert import read_model_dir
    from neko_tpu_torch.utils.checkpoint import NO_EMA

    device, mesh = ranks or (_device(cli), None)
    if _exported_model_dir(model_path):
        if cli.use_ema:
            raise ValueError(f"{NO_EMA}: {model_path} is an exported model.pt")
        cfg, sd = read_model_dir(model_path)
        if cli.kv_cache_dtype is not None:
            cfg = cfg.replace(kv_cache_dtype=cli.kv_cache_dtype)
        return serving_model(cfg, sd, device, mesh, cli.serve_weight_dtype), None
    ckpt_path, args = resolve_checkpoint_and_args(
        model_path, {"kv_cache_dtype": cli.kv_cache_dtype})
    # the device is this command's, never the training run's
    args.cpu, args.device = device.type == "cpu", device.type
    ctx, _ = build_context(args, tasks=[], ckpt_path=ckpt_path, ranks=ranks)
    return load_state_for(ctx, ckpt_path, use_ema=cli.use_ema,
                          weight_dtype=cli.serve_weight_dtype)


def build_generator(cli, model_path: Optional[str] = None, ranks=None):
    """CLI args -> Generator (the restore of `model_path`, default
    --model_path, or --random_init); over `ranks` (`serving_ranks`) this
    rank's."""
    from neko_tpu_torch.cli.build import serving_model
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.inference.generator import Generator

    if model_path is None and cli.random_init:
        if cli.use_ema:
            raise ValueError("--use_ema serves a checkpoint's EMA shadow; --random_init has none")
        arch = {k: getattr(cli, k) for k in _ARCH_FLAGS if getattr(cli, k) is not None}
        if cli.kv_cache_dtype is not None:
            arch["kv_cache_dtype"] = cli.kv_cache_dtype
        cfg = ModelConfig(**arch)
        device, mesh = ranks or (_device(cli), None)
        model = serving_model(cfg, init_state_dict(cfg, cli.seed), device, mesh,
                              cli.serve_weight_dtype)
        packer = None
    else:
        model, packer = load_model(cli, model_path or cli.model_path, ranks)
    return Generator(
        model, packer, seed=cli.seed,
        temperature=1.0 if cli.temperature is None else cli.temperature,
        top_k=0 if cli.sample_top_k is None else cli.sample_top_k,
        top_p=1.0 if cli.sample_top_p is None else cli.sample_top_p,
        weight_dtype=cli.serve_weight_dtype,
    )


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model_path",
                     help="checkpoint_<N> dir, or an experiment dir (latest used), or a "
                          "model.pt + config.json dir")
    src.add_argument("--random_init", action="store_true",
                     help="random weights from --seed and the architecture flags")
    p.add_argument("--seed", type=int, default=0,
                   help="weight seed (--random_init) and sampling seed")
    for name, typ in _ARCH_FLAGS.items():
        p.add_argument(f"--{name}", type=typ, default=None,
                       help="ModelConfig field for --random_init")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="serve on the CPU (the kernels' plain versions)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8,
                   help="micro-batch cap: concurrent compatible requests "
                        "coalesce into one decode call")
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--mesh_model_axis", type=int, default=None,
                   help="tensor-parallel serving degree: that many ranks under torchrun")
    p.add_argument("--kv_cache_dtype", type=str, default=None, choices=["native", "int8"],
                   help="int8: KV caches of int8 rows with fp32 row scales")
    p.add_argument("--serve_weight_dtype", type=str, default=None, choices=["bf16", "fp8"],
                   help="fp8: serve the matmul weights as e4m3 + per-channel scales "
                        "(inference/quant.py)")
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--sample_top_k", type=int, default=None)
    p.add_argument("--sample_top_p", type=float, default=None)
    p.add_argument("--use_ema", action="store_true", default=False,
                   help="serve the EMA shadow params (a checkpoint of a run with "
                        "--ema_decay > 0; the draft's too)")
    p.add_argument("--continuous_slots", type=int, default=0,
                   help="> 0: continuous batching for plain generate requests over "
                        "this many cache slots (serving/continuous.py)")
    p.add_argument("--continuous_chunk", type=int, default=8,
                   help="decode tokens per engine call")
    p.add_argument("--continuous_spec_k", type=int, default=0,
                   help="> 0: adaptive prompt-lookup speculation in the engine")
    p.add_argument("--continuous_spec_threshold", type=int, default=48,
                   help="run verify rounds only while some active row still wants "
                        ">= this many tokens")
    p.add_argument("--draft_model_path", type=str, default=None,
                   help="checkpoint of a (smaller) draft model sharing the token "
                        "space: speculative requests verify its proposals")
    p.add_argument("--self_draft_layers", type=int, default=None,
                   help="draft = the target's own first N layers "
                        "(Generator.truncated_draft); excludes --draft_model_path")
    p.add_argument("--compilation_cache", type=str, default=None,
                   help="the JAX package's compile cache (no counterpart here)")
    p.add_argument("--request_timeout", type=float, default=120.0,
                   help="per-request wall cap (s) before a 504")
    return p


def build_server(cli):
    """CLI args -> NekoServer (not started); under `--mesh_model_axis N` a
    rank other than 0 gets the `Follower` (`run()` replays rank 0's calls
    until its server closes)."""
    from neko_tpu_torch.cli.build import serving_ranks
    from neko_tpu_torch.parallel.multihost import process_index
    from neko_tpu_torch.serving.server import Follower, LockstepGenerator, NekoServer

    refuse_unported(cli)
    if cli.draft_model_path and cli.self_draft_layers:
        raise ValueError("--draft_model_path and --self_draft_layers are exclusive")
    ranks = serving_ranks(cli.mesh_model_axis, cli.cpu or cli.device == "cpu")
    gen = build_generator(cli, ranks=ranks)
    draft = (build_generator(cli, model_path=cli.draft_model_path, ranks=ranks)
             if cli.draft_model_path else None)
    if cli.self_draft_layers:
        draft = gen.truncated_draft(cli.self_draft_layers)
    if ranks is not None:
        if process_index() > 0:
            return Follower(gen, draft)
        gen = LockstepGenerator(gen, draft)
    return NekoServer(
        gen, host=cli.host, port=cli.port,
        max_batch=cli.max_batch, batch_window_ms=cli.batch_window_ms,
        continuous_slots=cli.continuous_slots, continuous_chunk=cli.continuous_chunk,
        continuous_spec_k=cli.continuous_spec_k,
        continuous_spec_threshold=cli.continuous_spec_threshold,
        draft_generator=draft, request_timeout=cli.request_timeout,
    )


def main(argv: Optional[list] = None) -> None:
    server = build_server(parser().parse_args(argv))
    if isinstance(server, Follower):
        server.run()
        return
    server.start()
    host, port = server.address[0], server.address[1]
    print(f"serving on http://{host}:{port} "
          f"(POST /v1/generate, /v1/action; GET /healthz, /metrics)", flush=True)
    try:
        server._serve_thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    if server.fault is not None:
        raise SystemExit(f"[neko-tpu-torch] serving stopped: {server.fault}")


if __name__ == "__main__":
    main()
