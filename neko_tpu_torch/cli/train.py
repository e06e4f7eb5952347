"""`python -m neko_tpu_torch.cli.train` -- the training entry point
(counterpart of neko_tpu/cli/train.py, `python train.py`).

    python -m neko_tpu_torch.cli.train --text_datasets synthetic \\
        --text_datasets_paths synthetic --text_prop 0.375 \\
        --control_datasets neko-synth-continuous-v0 neko-synth-image-v0 \\
        --embed_dim 768 --layers 6 --heads 24 -k 1024 --batch_size 16 \\
        --training_steps 30 --log_eval_freq 15 --save_model --save_mode checkpoint

The flags are the JAX package's (training/arguments.py).  The run trains on
the CUDA device (`--cpu` for the CPU), evaluates every `log_eval_freq`
steps, and with `--save_model` writes <save_dir>/<exp>/checkpoint_<N>/
(utils/checkpoint.py).  `--resume_from DIR` continues a run exactly: the
weights, optimizer state and step from the checkpoint, and the host sampler
state from its sidecar, so the data stream replays the uninterrupted run's.
`--init_checkpoint DIR` loads the weights of a checkpoint of this package,
`--init_checkpoint FILE.pt` migrates a reference (GatoPolicy) checkpoint
(models/import_reference.py).  `--pretrained_lm DIR` starts from the GPT-2
of a local HF directory (its widths, `gelu_new`, its weights over the
random ones: models/import_gpt2.py); a hub name is refused, since nothing is
downloaded.  `--lora` (with `--pretrained_lm`) adds fresh adapters of rank
`--lora_r` and trains only them.

Over several processes, one per device, launched by torchrun (or with
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set for each):

    torchrun --nproc_per_node 4 -m neko_tpu_torch.cli.train --multihost \\
        --mesh_model_axis 2 [--fsdp] ...

`--multihost` joins the group (NCCL with a card per rank, gloo when ranks
share cards or with `--cpu`); the ranks form a (data, seq, model) grid
with 'model' = `--mesh_model_axis`, 'seq' = `--mesh_seq_axis` (each rank
S / seq columns of the sequence, the attention a ring over them) and 'data'
the rest, or a (data, pipe, model) grid with `--mesh_pipe_axis` pipeline
stages (`--pipeline_schedule gpipe|1f1b`, `--pipeline_microbatches`);
`--batch_size` is the global batch, each data rank sampling its share
('seq' and 'pipe' peers the same rows); `--fsdp` also shards the large
parameters, their moments and the EMA over 'data'.  Rank 0 logs,
evaluates and writes the (canonical, mesh-independent) checkpoints, which
restore onto any mesh or into one process.
"""

from __future__ import annotations

import datetime
from typing import Optional

from neko_tpu_torch.cli.build import build_context
from neko_tpu_torch.parallel import multihost as mh
from neko_tpu_torch.training.arguments import TrainingArgs
from neko_tpu_torch.training.trainer import Trainer
from neko_tpu_torch.utils.typed_argparser import TypedArgumentParser


def run(args: TrainingArgs, exp_name: Optional[str] = None) -> Trainer:
    import torch

    from neko_tpu_torch.convert import model_shapes
    from neko_tpu_torch.utils import checkpoint as ckpt
    from neko_tpu_torch.utils.host_state import load_host_state_for

    ctx, tasks = build_context(args)
    exp_name = exp_name or datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S") + "_neko"
    exp_name = mh.broadcast_object(exp_name)  # every rank writes into rank 0's directory
    trainer = Trainer(ctx, tasks, exp_name, args)
    trainer.init_state(initial_weights(args, ctx))

    if args.resume_from is not None:
        path = ckpt.resolve_checkpoint_dir(args.resume_from)
        trainer.state = ckpt.load_checkpoint(path, ctx)
        trainer.steps = trainer.state.step
        host = load_host_state_for(path, trainer.proc_index, trainer.proc_count)
        if host is not None:
            trainer.load_host_state(host)
            print(f"resumed full train state from {path} at step {trainer.steps} "
                  "(host sampler state restored: exact)")
        else:
            # the stream restarts from the seed: it is this step's host state
            trainer.load_host_state(trainer.host_state())
            print(f"resumed device train state from {path} at step {trainer.steps} "
                  "(no host_state sidecar: the data stream restarts from the seed: "
                  "approximate resume)")

    n_local = sum(p.numel() for p in trainer.state.model.parameters())
    n_params = sum(s.numel() for s in model_shapes(ctx.model_cfg).values())
    where = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    if trainer.is_main_process:
        print(f"device: {ctx.device} ({where})")
        print(f"mesh: {dict(ctx.mesh.shape) if ctx.mesh is not None else {}}"
              + (", fsdp" if ctx.fsdp and ctx.on_ranks else ""))
        print(f"parameters: {n_params:,}" + (f" (this rank holds {n_local:,})"
                                             if ctx.on_ranks else ""))
    trainer.train()
    return trainer


def initial_weights(args: TrainingArgs, ctx):
    """The canonical weights the run starts from, or None for the random
    ones of the seed, in the JAX package's order: the random weights, the
    GPT-2 of `--pretrained_lm` over them, then `--init_checkpoint`: a
    reference `.pt` over those, or the weights of a checkpoint dir of this
    package (an experiment dir: its latest) in their place.  The context
    lays them out for its mesh (`TrainContext.init_state`)."""
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.utils import checkpoint as ckpt

    sd = None
    if args.pretrained_lm is not None:
        from neko_tpu_torch.models.import_gpt2 import load_pretrained_gpt2

        sd = load_pretrained_gpt2(init_state_dict(ctx.model_cfg, ctx.seed),
                                  args.pretrained_lm, ctx.model_cfg.layers)
        print(f"imported GPT-2 weights from {args.pretrained_lm}")
    if args.init_checkpoint is None:
        return sd
    if args.init_checkpoint.endswith(".pt"):
        from neko_tpu_torch.models.import_reference import load_reference_checkpoint

        sd = load_reference_checkpoint(
            args.init_checkpoint, sd if sd is not None else init_state_dict(
                ctx.model_cfg, ctx.seed), ctx.model_cfg)
        print(f"migrated reference checkpoint {args.init_checkpoint}")
        return sd
    return ckpt.load_params_only(ckpt.resolve_checkpoint_dir(args.init_checkpoint),
                                 ctx.model_cfg)


def validate_args(args: TrainingArgs) -> None:
    """The reference's startup checks."""
    def need(ok, msg):
        if not ok:
            raise ValueError(msg)

    for name in ("text_prop", "caption_prop", "vqa_prop"):
        need(0.0 <= getattr(args, name) <= 1.0, f"--{name} must lie in [0, 1]")
    need(args.text_prop + args.caption_prop + args.vqa_prop <= 1.0,
         "text/caption/vqa proportions must sum to <= 1")
    if 1 - args.text_prop - args.caption_prop - args.vqa_prop > 1e-6:
        need(args.control_datasets,
             "control data proportion > 0 but no --control_datasets specified")
    if args.text_prop > 0:
        need(args.text_datasets and args.text_datasets_paths,
             "text proportion > 0 but no --text_datasets/--text_datasets_paths")
    need(args.training_steps >= args.log_eval_freq, "training_steps must be >= log_eval_freq")
    if args.lora:
        need(args.pretrained_lm is not None, "--lora requires --pretrained_lm")


def main(argv: Optional[list] = None) -> Trainer:
    (args,) = TypedArgumentParser(TrainingArgs).parse_args_into_dataclasses(argv)
    validate_args(args)
    return run(args)


if __name__ == "__main__":
    main()
