"""TrainingArgs: the training CLI's flags (counterpart of
neko_tpu/training/arguments.py).

Every field of the JAX package's TrainingArgs is kept, with its default, so
its command lines and `args.json` files parse here unchanged; `--device`
defaults to the CUDA device.  `not_ported(args)` names the flags that select
what the port does not run yet (`cli/train.py` raises NotImplementedError
for them).  `flash`, `rng_impl` and `compilation_cache` select JAX
machinery and are ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Literal, Optional


@dataclass
class TrainingArgs:
    # Device / precision (reference:20-27)
    cpu: bool = field(default=False, metadata={"help": "Run on the CPU instead of the CUDA device."})
    device: Literal["cpu", "cuda"] = field(default="cuda", metadata={"help": "cuda (the default) needs a visible CUDA device; cpu runs the kernels' plain versions."})
    mixed_precision: Literal["no", "fp16", "bf16", "fp8"] = field(default="bf16", metadata={"help": "bf16 activations over fp32 params; 'no' computes in fp32; fp16 and fp8 compute in bf16, as the JAX package maps them."})

    # Input & tokenization (reference:29-44)
    sequence_length: int = field(default=1024, metadata={"aliases": ["-k"]})
    patch_size: int = field(default=16)
    resid_mid_channels: int = field(default=128)
    num_groups: int = field(default=32)
    patch_position_vocab_size: int = field(default=128)
    disable_patch_pos_encoding: bool = field(default=False)
    disable_inner_pos_encoding: bool = field(default=False)
    mu: int = field(default=100)
    M: int = field(default=256)
    continuous_tokens: int = field(default=1024)
    discrete_tokens: int = field(default=1024)

    # Transformer architecture (reference:46-55)
    tokenizer_model_name: str = field(default="gpt2")
    pretrained_lm: Optional[str] = field(default=None)
    flash: bool = field(default=True)
    init_checkpoint: Optional[str] = field(default=None, metadata={"help": "Load the weights (not the optimizer state) of a checkpoint_<N> dir written by this package."})
    resume_from: Optional[str] = field(default=None, metadata={"help": "Resume params, optimizer state and step from an experiment dir (its latest checkpoint) or a checkpoint_<N> dir, and the host sampler state from its sidecar: the data stream replays the uninterrupted run's."})
    embed_dim: int = field(default=768)
    layers: int = field(default=8)
    heads: int = field(default=24)
    activation_fn: str = field(default="gelu")

    # LoRA (reference:57-61)
    lora: bool = field(default=False)
    lora_r: int = field(default=8)
    lora_alpha: int = field(default=32)
    lora_dropout: float = field(default=0.1)

    # Training hyperparameters (reference:63-96)
    text_prop: float = field(default=0.0)
    caption_prop: float = field(default=0.0)
    vqa_prop: float = field(default=0.0)
    gradient_accumulation_steps: int = field(default=1)
    batch_size: int = field(default=512)
    dropout: float = field(default=0.1)
    stochastic_depth: float = field(default=0.0)
    observation_loss: bool = field(default=False)
    beta_1: float = field(default=0.9)
    beta_2: float = field(default=0.95)
    adam_eps: float = field(default=1e-8)
    weight_decay: float = field(default=0.1)
    grad_norm_clip: float = field(default=1.0)
    disable_grad_clip: bool = field(default=False)
    warmup_steps: int = field(default=15000)
    init_lr: float = field(default=1e-7)
    learning_rate: float = field(default=1e-4)
    min_factor: float = field(default=10.0)
    disable_cosine_decay: bool = field(default=False)
    training_steps: int = field(default=1_000_000)
    log_eval_freq: int = field(default=100_000)
    pad_seq: bool = field(default=False)

    # Evaluation (reference:91-96)
    eval_episodes: int = field(default=10)
    eval_parallel_episodes: int = field(default=0, metadata={"help": "Control-eval episodes rolled out in lockstep; 0 = auto (min(eval_episodes, 8)), 1 = serial."})
    eval_mode: Literal["deterministic", "stochastic"] = field(default="deterministic")
    promptless_eval: bool = field(default=False)
    eval_text_num_examples: int = field(default=100)
    eval_text_log_examples: bool = field(default=False)

    # Datasets / envs (reference:98-123)
    control_datasets: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    text_datasets: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    text_datasets_paths: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    caption_dataset: str = field(default="")
    caption_train_data: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    caption_test_data: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    test_data_prop: float = field(default=0.1)
    vqa_dataset: str = field(default="")
    vqa_train_data: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    vqa_test_data: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    train_img_name_prefix: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    train_img_file_name_len: List[int] = field(default_factory=list, metadata={"nargs": "+"})
    test_img_name_prefix: List[str] = field(default_factory=list, metadata={"nargs": "+"})
    test_img_file_name_len: List[int] = field(default_factory=list, metadata={"nargs": "+"})
    caption_image_size: int = field(default=256)
    vqa_image_size: int = field(default=256)
    questions_file: str = field(default="questions.json")
    annotations_file: str = field(default="annotations.json")
    eval_caption_num_examples: int = field(default=100)
    eval_caption_log_examples: bool = field(default=False)
    eval_vqa_num_examples: int = field(default=100)
    eval_vqa_log_examples: bool = field(default=False)

    # Prompt sampling (reference:125-129)
    prompt_ep_proportion: float = field(default=0.25)
    prompt_len_proportion: float = field(default=0.5)
    unique_prompt_episodes: bool = field(default=False)
    top_k: Optional[int] = field(default=None)

    # Logging (reference:131-133)
    use_wandb: bool = field(default=False)
    wandb_project: str = field(default="neko-tpu")

    # Saving (reference:135-138)
    save_model: bool = field(default=False)
    save_mode: Literal["checkpoint", "last"] = field(default="last")
    save_dir: str = field(default="models")

    # ---- extensions of the JAX package (not in the reference) ----
    mesh_model_axis: int = field(default=1)
    mesh_seq_axis: int = field(default=1, metadata={"help": "Sequence shards of the mesh (on the one device): > 1 trains every layer's attention as ring attention over them."})
    mesh_pipe_axis: int = field(default=1)
    pipeline_microbatches: int = field(default=4)
    pipeline_schedule: Literal["gpipe", "1f1b"] = field(default="gpipe")
    fsdp: bool = field(default=False)
    max_patches: int = field(default=-1, metadata={"help": "Static per-example image-patch budget; -1 = derive from the tasks."})
    remat: bool = field(default=False)
    fused_adamw: bool = field(default=False, metadata={"help": "The optimizer as the fused AdamW kernel: clip, moments and update in one launch over the whole tree."})
    ema_decay: float = field(default=0.0)
    seed: int = field(default=42)
    prefetch_batches: int = field(default=2, metadata={"help": "Host batches packed (and copied to the device) ahead of the step by a background thread; 0 disables."})
    prefetch_workers: int = field(default=1, metadata={"help": "Prefetch threads; > 1 makes the batch order depend on scheduling, so --save_model refuses it."})
    profile_dir: Optional[str] = field(default=None, metadata={"help": "Trace train steps [2, 2 + profile_steps) with torch.profiler and write the Chrome trace into this directory."})
    profile_steps: int = field(default=3, metadata={"help": "Number of steps to trace when --profile_dir is set."})
    multihost: bool = field(default=False)
    compilation_cache: Optional[str] = field(default=None)
    rng_impl: Literal["threefry", "rbg", "unsafe_rbg"] = field(default="unsafe_rbg")
    log_jsonl: bool = field(default=True, metadata={"help": "Append metrics to <save_dir>/<exp>/metrics.jsonl."})
    kv_cache_dtype: Literal["native", "int8"] = field(default="native")


def resolve_parallel_episodes(requested: int, n_iterations: int) -> int:
    """--eval_parallel_episodes: 0 = auto (lockstep up to 8 episodes),
    N > 0 = exactly N (never more than the episode count)."""
    if requested and requested > 0:
        return min(requested, max(n_iterations, 1))
    return min(max(n_iterations, 1), 8)


def not_ported(args: TrainingArgs) -> List[str]:
    """The flags of `args` that select what neko_tpu_torch does not run yet."""
    unported = {
        "--lora": args.lora,
        "--pretrained_lm": args.pretrained_lm is not None,
        "--init_checkpoint <file>.pt": str(args.init_checkpoint or "").endswith(".pt"),
        "--fsdp": args.fsdp,
        "--multihost": args.multihost,
        "--mesh_model_axis > 1": args.mesh_model_axis > 1,
        "--mesh_pipe_axis > 1": args.mesh_pipe_axis > 1,
        "--kv_cache_dtype int8": args.kv_cache_dtype != "native",
    }
    return [name for name, on in unported.items() if on]
