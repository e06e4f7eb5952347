"""Train state + the train step on one device (counterpart of
neko_tpu/training/train_state.py).

The JAX package jit-compiles one pure step over a ('data', 'model') mesh:
value_and_grad of `NekoModel(deterministic=False, compute_loss=True)`, then
the optax chain clip_by_global_norm -> adamw on the warmup-cosine schedule.
Here the step runs eagerly on one device and updates the state in place:

* the loss and gradients come from `NekoModel.forward(train=True)` and
  autograd, every random draw from one `torch.Generator` on the device,
  seeded from (seed, step) as the JAX step folds the step into its key;
* the gradients are clipped to a global norm as optax writes it
  (g * max_norm / norm when norm >= max_norm; no epsilon in the denominator,
  unlike `torch.nn.utils.clip_grad_norm_`), computed on the device;
* `torch.optim.AdamW(b1, b2, eps, weight_decay)` applies the update, with
  the learning rate read from the schedule at the optimizer's update count
  before the update, as optax's `scale_by_learning_rate` reads it (count 0
  at the first update).  torch's decoupled decay p *= 1 - lr * wd before
  the Adam step is optax's add_decayed_weights after it: the same update.

`TrainContext(..., mesh=create_mesh(data=1, seq=n))` runs its steps under
the mesh, as the JAX `TrainContext` does: the attention of every layer then
runs as ring attention over n sequence shards that live on the one device
(`ops/ring_kernel.py`); the context length must split over them.  The rest
of the step is unchanged, and the same converted weights load.

Not ported yet (NotImplementedError): `lora_only`, gradient accumulation,
EMA, `fused_adamw`, FSDP, and a mesh whose 'seq' axis lies over the ranks of
a process group (the model, the batch and the optimizer are not yet sharded
over processes; the ring itself is, `ring_kernel.ring_attention_bsd`).  The
pipeline fields of `OptimizerConfig` are ignored, as the JAX package ignores
them off a 'pipe' mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.data.batch import PackedBatch
from neko_tpu_torch.models.policy import NekoModel
from neko_tpu_torch.parallel.mesh import Mesh, seq_axis_size
from neko_tpu_torch.training.schedulers import linear_warmup_cosine_decay


@dataclasses.dataclass
class OptimizerConfig:
    """Field for field neko_tpu's OptimizerConfig (the reference's flags)."""

    learning_rate: float = 1e-4
    init_lr: float = 1e-7
    min_factor: float = 10.0
    warmup_steps: int = 15_000
    training_steps: int = 1_000_000
    disable_cosine_decay: bool = False
    beta_1: float = 0.9
    beta_2: float = 0.95
    adam_eps: float = 1e-8
    weight_decay: float = 0.1
    grad_norm_clip: float = 1.0
    disable_grad_clip: bool = False
    gradient_accumulation_steps: int = 1
    lora_only: bool = False
    ema_decay: float = 0.0
    pipeline_microbatches: int = 4
    pipeline_schedule: str = "gpipe"
    fused_adamw: bool = False


def _not_ported(cfg: OptimizerConfig, fsdp: bool) -> None:
    unported = {
        "lora_only": cfg.lora_only,
        "gradient_accumulation_steps > 1": cfg.gradient_accumulation_steps > 1,
        "ema_decay > 0": cfg.ema_decay > 0.0,
        "fused_adamw": cfg.fused_adamw,
        "fsdp": fsdp,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"not yet ported to neko_tpu_torch training: {bad}")


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    return linear_warmup_cosine_decay(
        base_lr=cfg.learning_rate,
        init_lr=cfg.init_lr,
        min_lr=cfg.learning_rate / cfg.min_factor,
        warmup_steps=cfg.warmup_steps,
        total_steps=cfg.training_steps,
        cosine_decay=not cfg.disable_cosine_decay,
    )


def make_optimizer(
    cfg: OptimizerConfig, params: List[torch.nn.Parameter]
) -> Tuple[torch.optim.AdamW, Callable[[int], float]]:
    """-> (AdamW over `params`, schedule(update count) -> lr).  Every
    parameter is decayed, as the reference's torch AdamW does."""
    opt = torch.optim.AdamW(
        params, lr=0.0, betas=(cfg.beta_1, cfg.beta_2), eps=cfg.adam_eps,
        weight_decay=cfg.weight_decay,
    )
    return opt, make_schedule(cfg)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g -> g / norm * max_norm when the
    global norm is >= max_norm.  Returns the norm (a device scalar)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, g / norm.to(g.dtype) * max_norm))
    return norm


def step_seed(seed: int, step: int) -> int:
    """The step's generator seed from (seed, step): distinct for every pair
    with step < 2**32."""
    return ((seed + 1) << 32) + step


@dataclasses.dataclass
class TrainState:
    step: int
    model: NekoModel          # fp32 parameters on the device
    optimizer: torch.optim.AdamW
    seed: int


class TrainContext:
    """Owns the model config, optimizer config and device; runs the steps."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: OptimizerConfig,
        device="cuda",
        seed: int = 0,
        fsdp: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        _not_ported(opt_cfg, fsdp)
        if mesh is not None and mesh.seq_group is not None:
            raise NotImplementedError(
                "a 'seq' axis over the ranks of a process group: the model and the "
                "batch are not yet sharded over processes")
        n = seq_axis_size(mesh)
        if model_cfg.context_len % n:
            raise ValueError(f"context_len={model_cfg.context_len} does not split over "
                             f"the mesh's {n} sequence shards")
        self.mesh = mesh
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.device = torch.device(device)
        self.seed = seed
        self.schedule = make_schedule(opt_cfg)

    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """Fresh state: the given weights, or random ones as the JAX package
        initializes them, drawn from numpy seeded with `seed`."""
        from neko_tpu_torch.convert import build_model, init_state_dict

        if state_dict is None:
            state_dict = init_state_dict(self.model_cfg, self.seed)
        model = build_model(self.model_cfg, state_dict, self.device)
        opt, _ = make_optimizer(self.opt_cfg, list(model.parameters()))
        return TrainState(step=0, model=model, optimizer=opt, seed=self.seed)

    def step_generator(self, state: TrainState) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            step_seed(state.seed, state.step))

    def loss_and_grads(self, state: TrainState, batch: PackedBatch) -> torch.Tensor:
        """Train-mode loss of `batch` with the step's generator; leaves the
        gradients in the parameters' `.grad`.  -> loss (device scalar)."""
        state.optimizer.zero_grad(set_to_none=True)
        with self.mesh or contextlib.nullcontext():
            _, loss = state.model(batch, train=True, compute_loss=True,
                                  generator=self.step_generator(state))
        # the backward pass reads no mesh: each autograd node carries its own
        loss.backward()
        return loss.detach()

    def train_step(self, state: TrainState, batch: PackedBatch):
        """One optimizer step in place.  -> (state, loss as a device scalar:
        reading it is the caller's choice, the step never syncs)."""
        loss = self.loss_and_grads(state, batch)
        self.apply_gradients(state)
        return state, loss

    def apply_gradients(self, state: TrainState) -> None:
        """The optimizer half of a step: clip the gradients in `.grad`, set
        the learning rate of this update, apply AdamW, count the step."""
        with torch.profiler.record_function("optimizer"):
            if not self.opt_cfg.disable_grad_clip:
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                clip_by_global_norm_(grads, self.opt_cfg.grad_norm_clip)
            lr = self.schedule(state.step)  # the update count before this update
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        state.step += 1

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: PackedBatch) -> torch.Tensor:
        """Deterministic loss on a batch (no grads, no dropout)."""
        with self.mesh or contextlib.nullcontext():
            _, loss = state.model(batch, compute_loss=True)
        return loss

    def current_lr(self, step: int) -> float:
        return self.schedule(step)
