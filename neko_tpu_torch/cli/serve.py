"""`python -m neko_tpu_torch.cli.serve` -- HTTP inference server (counterpart
of neko_tpu/cli/serve.py).

    python -m neko_tpu_torch.cli.serve --model_path DIR [--device cuda]
    python -m neko_tpu_torch.cli.serve --random_init --seed 0 \\
        --embed_dim 768 --layers 6 --heads 24 --context_len 1024

DIR holds `model.pt` (the state_dict) and `config.json` (the ModelConfig
fields), as tools/export_torch_checkpoint.py writes them from a neko_tpu
checkpoint.  `--random_init` builds random weights from `--seed` and the
architecture flags instead, for smoke runs.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from neko_tpu_torch.config import ModelConfig

# architecture flags of --random_init: ModelConfig field -> type
_ARCH_FLAGS = {
    "embed_dim": int, "layers": int, "heads": int, "context_len": int,
    "text_tokens": int, "continuous_tokens": int, "discrete_tokens": int,
    "max_patches": int, "patch_size": int, "dtype": str,
}


def build_generator(cli):
    """CLI args -> Generator on cli.device."""
    from neko_tpu_torch.convert import build_model, init_state_dict, load_model_dir
    from neko_tpu_torch.inference.generator import Generator

    device = torch.device(cli.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible")
    if cli.random_init:
        arch = {k: getattr(cli, k) for k in _ARCH_FLAGS if getattr(cli, k) is not None}
        cfg = ModelConfig(**arch)
        model = build_model(cfg, init_state_dict(cfg, cli.seed), device)
    else:
        cfg, model = load_model_dir(cli.model_path, device)
    return Generator(
        model, seed=cli.seed,
        temperature=1.0 if cli.temperature is None else cli.temperature,
        top_k=0 if cli.sample_top_k is None else cli.sample_top_k,
        top_p=1.0 if cli.sample_top_p is None else cli.sample_top_p,
    )


def main(argv: Optional[list] = None) -> None:
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--model_path", help="directory with model.pt + config.json")
    src.add_argument("--random_init", action="store_true",
                     help="random weights from --seed and the architecture flags")
    p.add_argument("--seed", type=int, default=0,
                   help="weight seed (--random_init) and sampling seed")
    for name, typ in _ARCH_FLAGS.items():
        p.add_argument(f"--{name}", type=typ, default=None,
                       help="ModelConfig field for --random_init")
    p.add_argument("--device", default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8,
                   help="micro-batch cap: concurrent compatible requests "
                        "coalesce into one decode call")
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--sample_top_k", type=int, default=None)
    p.add_argument("--sample_top_p", type=float, default=None)
    p.add_argument("--request_timeout", type=float, default=120.0,
                   help="per-request wall cap (s) before a 504")
    cli = p.parse_args(argv)

    from neko_tpu_torch.serving.server import NekoServer

    gen = build_generator(cli)
    server = NekoServer(
        gen, host=cli.host, port=cli.port,
        max_batch=cli.max_batch, batch_window_ms=cli.batch_window_ms,
        request_timeout=cli.request_timeout,
    ).start()
    host, port = server.address[0], server.address[1]
    print(f"serving on http://{host}:{port} "
          f"(POST /v1/generate, /v1/action; GET /healthz)", flush=True)
    try:
        server._serve_thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
