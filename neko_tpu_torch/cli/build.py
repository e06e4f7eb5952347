"""Shared construction: TrainingArgs -> (TrainContext, tasks), and the
restore recipe that evaluation shares with serving (counterpart of
neko_tpu/cli/build.py)."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.parallel import multihost as mh
from neko_tpu_torch.parallel.mesh import create_mesh
from neko_tpu_torch.tasks.base import Task
from neko_tpu_torch.tasks.control import ControlTask
from neko_tpu_torch.tasks.text import TextTask
from neko_tpu_torch.tokenizers.text import get_text_tokenizer
from neko_tpu_torch.training.arguments import TrainingArgs, not_ported
from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext


def select_device(args: TrainingArgs) -> torch.device:
    """--cpu / --device cpu: the CPU; otherwise the CUDA device, which must
    be visible (there is no fallback)."""
    if args.cpu or args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is visible (pass --cpu to run "
                         "the kernels' plain versions on the CPU)")
    return torch.device("cuda")


def check_ported(args: TrainingArgs) -> None:
    bad = not_ported(args)
    if bad:
        raise NotImplementedError(f"not yet ported to neko_tpu_torch: {bad}")


def build_control_tasks(args: TrainingArgs, context_len: int,
                        seed: Optional[int] = None) -> List[ControlTask]:
    if not args.control_datasets:
        return []
    from neko_tpu_torch.envs.setup_env import expand_dataset_names, load_envs

    if seed is None:
        seed = mh.host_seed(args.seed)
    envs, datasets = load_envs(args.control_datasets)
    names = expand_dataset_names(args.control_datasets)
    return [
        ControlTask(name, env, dataset, context_len=context_len,
                    patch_size=args.patch_size,
                    training_prompt_len_proportion=args.prompt_len_proportion,
                    share_prompt_episodes=not args.unique_prompt_episodes,
                    top_k_prompting=args.top_k, seed=seed)
        for name, env, dataset in zip(names, envs, datasets)
    ]


def build_tasks(args: TrainingArgs) -> List[Task]:
    seed = mh.host_seed(args.seed)
    tasks: List[Task] = list(build_control_tasks(args, args.sequence_length, seed))
    if args.text_datasets:
        tasks.append(TextTask(args.text_datasets, args.text_datasets_paths,
                              context_length=args.sequence_length,
                              tokenizer_model=args.tokenizer_model_name, seed=seed))
    if args.caption_dataset:
        from neko_tpu_torch.tasks.caption import CaptionTask

        tasks.append(CaptionTask(
            args.caption_dataset, train_data=args.caption_train_data,
            test_data=args.caption_test_data, test_data_prop=args.test_data_prop,
            tokenizer_model=args.tokenizer_model_name, patch_size=args.patch_size,
            image_size=args.caption_image_size, context_length=args.sequence_length,
            seed=seed))
    if args.vqa_dataset:
        from neko_tpu_torch.tasks.vqa import VqaTask

        tasks.append(VqaTask(
            args.vqa_dataset, train_data=args.vqa_train_data, test_data=args.vqa_test_data,
            train_img_name_prefix=args.train_img_name_prefix,
            train_img_file_name_len=args.train_img_file_name_len,
            test_img_name_prefix=args.test_img_name_prefix,
            test_img_file_name_len=args.test_img_file_name_len,
            questions_file=args.questions_file, annotations_file=args.annotations_file,
            tokenizer_model=args.tokenizer_model_name, patch_size=args.patch_size,
            image_size=args.vqa_image_size, context_length=args.sequence_length, seed=seed))
    return tasks


def derive_max_patches(args: TrainingArgs, tasks: List[Task]) -> int:
    if args.max_patches >= 0:
        return args.max_patches
    required = [0]
    for t in tasks:
        if isinstance(t, ControlTask):
            required.append(t.required_patches)
        elif getattr(t, "task_kind", "") in ("caption", "vqa"):
            required.append(t.patches_per_image)
    return max(required)


def model_config_from_args(args: TrainingArgs, max_patches: int) -> ModelConfig:
    # fp16 and fp8 compute in bf16, as the JAX package maps them
    dtype = {"no": "float32", "bf16": "bfloat16", "fp16": "bfloat16",
             "fp8": "bfloat16"}[args.mixed_precision]
    tok = get_text_tokenizer(args.tokenizer_model_name)
    return ModelConfig(
        embed_dim=args.embed_dim,
        layers=args.layers,
        heads=args.heads,
        dropout=args.dropout,
        stochastic_depth=args.stochastic_depth,
        observation_loss=args.observation_loss,
        activation_fn=args.activation_fn,
        text_tokens=int(tok.vocab_size),
        continuous_tokens=args.continuous_tokens,
        discrete_tokens=args.discrete_tokens,
        context_len=args.sequence_length,
        mu=args.mu,
        M=args.M,
        patch_size=args.patch_size,
        resid_mid_channels=args.resid_mid_channels,
        num_groups=args.num_groups,
        position_vocab_size=args.patch_position_vocab_size,
        use_pos_encoding=not args.disable_inner_pos_encoding,
        use_patch_pos_encoding=not args.disable_patch_pos_encoding,
        max_patches=max_patches,
        dtype=dtype,
        attention_impl="flash" if args.flash else "xla",
        kv_cache_dtype=args.kv_cache_dtype,
        remat=args.remat,
        lora_r=args.lora_r if args.lora else 0,
        lora_alpha=args.lora_alpha,
        lora_dropout=args.lora_dropout,
    )


def optimizer_config_from_args(args: TrainingArgs) -> OptimizerConfig:
    return OptimizerConfig(
        learning_rate=args.learning_rate,
        init_lr=args.init_lr,
        min_factor=args.min_factor,
        warmup_steps=args.warmup_steps,
        training_steps=args.training_steps,
        disable_cosine_decay=args.disable_cosine_decay,
        beta_1=args.beta_1,
        beta_2=args.beta_2,
        adam_eps=args.adam_eps,
        weight_decay=args.weight_decay,
        grad_norm_clip=args.grad_norm_clip,
        disable_grad_clip=args.disable_grad_clip,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lora_only=bool(args.lora),
        ema_decay=args.ema_decay,
        pipeline_microbatches=args.pipeline_microbatches,
        pipeline_schedule=args.pipeline_schedule,
        fused_adamw=args.fused_adamw,
    )


def serving_max_patches(ckpt_path: str, args: TrainingArgs) -> int:
    """Patch-pool size for a task-less (serving) restore.  A task-less build
    derives max_patches 0 when args leave it at -1, and its model would lack
    the image embedder an image-trained checkpoint carries.  The
    checkpoint's config says whether the embedder exists; one full 256x256
    image (the caption / VQA serving shape) is then enough for
    predict_response."""
    if args.max_patches >= 0:
        return args.max_patches
    from neko_tpu_torch.utils.checkpoint import saved_model_config

    try:
        saved = saved_model_config(ckpt_path)
    except (OSError, ValueError):
        return -1
    return (256 // args.patch_size) ** 2 if saved.max_patches > 0 else -1


def build_context(args: TrainingArgs, tasks: Optional[List[Task]] = None,
                  ckpt_path: Optional[str] = None) -> Tuple[TrainContext, List[Task]]:
    """(TrainContext on the selected device, tasks).  With no tasks and a
    `ckpt_path` (a serving restore) the patch pool is sized from the
    checkpoint.  `--mesh_seq_axis N` puts N sequence shards on the one
    device (ring attention); the other mesh axes wait for the port of
    multi-device training."""
    check_ported(args)
    device = select_device(args)
    if tasks is None:
        tasks = build_tasks(args)
    elif not tasks and ckpt_path is not None:
        args.max_patches = serving_max_patches(ckpt_path, args)
    model_cfg = model_config_from_args(args, derive_max_patches(args, tasks))
    if args.sequence_length % args.mesh_seq_axis:
        raise ValueError(f"context len {args.sequence_length} must divide evenly over "
                         f"mesh_seq_axis={args.mesh_seq_axis} sequence shards")
    mesh = None
    if args.mesh_seq_axis > 1:
        mesh = create_mesh(data=1, model=args.mesh_model_axis, seq=args.mesh_seq_axis,
                           pipe=args.mesh_pipe_axis, seq_group=None)
    ctx = TrainContext(model_cfg, optimizer_config_from_args(args), device=device,
                       seed=args.seed, fsdp=args.fsdp, mesh=mesh)
    return ctx, tasks


def resolve_checkpoint_and_args(model_path: str, overrides: Optional[dict] = None):
    """The inference restore recipe, step 1: resolve `model_path` (a
    checkpoint_<N> dir, or an experiment dir whose latest checkpoint is
    used), load the adjacent args.json and merge the non-None `overrides`.
    -> (checkpoint path, TrainingArgs)."""
    from neko_tpu_torch.utils.checkpoint import load_args_dict, resolve_checkpoint_dir

    ckpt_path = resolve_checkpoint_dir(model_path)
    saved = load_args_dict(os.path.dirname(os.path.abspath(ckpt_path)))
    saved.update({k: v for k, v in (overrides or {}).items() if v is not None})
    known = set(TrainingArgs.__dataclass_fields__)
    return ckpt_path, TrainingArgs(**{k: v for k, v in saved.items() if k in known})


def load_state_for(ctx: TrainContext, ckpt_path: str, use_ema: bool = False):
    """The inference restore recipe, step 2: the checkpoint's weights (its
    EMA shadow with `use_ema`) in a model of `ctx`'s configuration on
    `ctx`'s device.  The patch pool (`max_patches`) sizes the packer, not
    the weights, so it may differ from the checkpoint's; every other field
    must match.  -> (model, packer)."""
    from neko_tpu_torch.convert import build_model
    from neko_tpu_torch.data.packing import SequencePacker
    from neko_tpu_torch.utils.checkpoint import (load_ema_params, load_params_only,
                                                 saved_model_config)

    if (saved_model_config(ckpt_path).max_patches > 0) != (ctx.model_cfg.max_patches > 0):
        raise ValueError(
            f"{ckpt_path} was trained {'with' if ctx.model_cfg.max_patches == 0 else 'without'} "
            "an image embedder, the restore's tasks derive the opposite; set --max_patches")
    load = load_ema_params if use_ema else load_params_only
    sd = load(ckpt_path, ctx.model_cfg, ignore=("max_patches",))
    return build_model(ctx.model_cfg, sd, ctx.device), SequencePacker(ctx.model_cfg)
