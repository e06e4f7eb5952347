"""Export a checkpoint of this package as a reference-format `.pt`
(counterpart of tools/export_checkpoint.py).

    python -m neko_tpu_torch.tools.export_checkpoint --model_path runs/<exp> \\
        --out checkpoint_ref.pt [--no_merge_lora] [--wte_rows 50257]

`--model_path` is a checkpoint_<N> dir written by `python -m
neko_tpu_torch.cli.train` or its experiment dir (the latest checkpoint).
The weights (`model.pt`) and the ModelConfig the run resolved from its
args.json (`config.json`) go through models/export_reference.py into the
state dict the reference's save_model writes, loadable with
`GatoPolicy(...).load_state_dict(sd, strict=True)`.  Runs on the CPU: no
model is built.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True,
                   help="checkpoint_<N> dir, or an experiment dir (latest used)")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--no_merge_lora", action="store_true",
                   help="keep the base c_attn weight instead of folding the LoRA adapters "
                        "in (the adapters are then dropped)")
    p.add_argument("--wte_rows", type=int, default=1,
                   help="rows of the reference's unused transformer.wte: 1 for a fresh "
                        "GatoPolicy, 50257 for a --pretrained_lm one")
    return p


def main(argv: Optional[list] = None) -> str:
    from neko_tpu_torch.models.export_reference import save_reference_checkpoint
    from neko_tpu_torch.utils import checkpoint as ckpt

    cli = parser().parse_args(argv)
    path = ckpt.resolve_checkpoint_dir(cli.model_path)
    cfg = ckpt.saved_model_config(path)
    sd = ckpt.load_params_only(path, cfg)
    save_reference_checkpoint(cli.out, sd, cfg, merge_lora=not cli.no_merge_lora,
                              wte_rows=cli.wte_rows)
    step = torch.load(os.path.join(path, ckpt.TRAIN_STATE), map_location="cpu",
                      weights_only=True)["step"]
    print(f"wrote {cli.out} (from {path}, step {step})")
    return cli.out


if __name__ == "__main__":
    main()
