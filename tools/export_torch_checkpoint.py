"""Export a trained neko-tpu checkpoint as a neko_tpu_torch model directory.

    python tools/export_torch_checkpoint.py --model_path models/<exp>/ --out DIR [--use_ema]

Runs where JAX is installed.  Restores the Orbax checkpoint (latest under an
experiment dir, or an explicit checkpoint_<N> dir) with its args.json through
neko_tpu's own restore path (neko_tpu/cli/build.py), converts the flax params
with neko_tpu_torch/convert.py and writes DIR/model.pt (the state_dict) and
DIR/config.json (the ModelConfig fields).  Serve DIR on a GPU with

    python -m neko_tpu_torch.cli.serve --model_path DIR
"""

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def export_params(params, model_cfg, out: str) -> None:
    """neko_tpu params pytree + neko_tpu ModelConfig -> model directory."""
    import jax

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import jax_params_to_state_dict, save_model_dir

    cfg = ModelConfig.from_dict(dataclasses.asdict(model_cfg))
    params_np = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    save_model_dir(out, cfg, jax_params_to_state_dict(params_np, cfg))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True,
                   help="checkpoint_<N> dir, or an exp dir (latest used)")
    p.add_argument("--out", required=True, help="output model directory")
    p.add_argument("--use_ema", action="store_true",
                   help="export the EMA shadow params")
    cli = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from neko_tpu.cli.build import (
        build_context,
        load_state_for,
        resolve_checkpoint_and_args,
    )

    ckpt, args = resolve_checkpoint_and_args(cli.model_path, {"cpu": True})
    ctx, _ = build_context(args, tasks=[], ckpt_path=ckpt)
    state, _ = load_state_for(ctx, ckpt)
    params = state.params
    if cli.use_ema:
        if state.ema_params is None:
            raise SystemExit("checkpoint has no EMA shadow (train with --ema_decay > 0)")
        params = state.ema_params
    export_params(params, ctx.model_cfg, cli.out)
    print(f"wrote {cli.out} (from {ckpt}, step {int(state.step)})")


if __name__ == "__main__":
    main()
