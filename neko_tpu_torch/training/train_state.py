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
* with `OptimizerConfig(fused_adamw=True)` (the JAX package's
  `--fused_adamw`) the optimizer is `FusedAdamW` instead: the global norm on
  the device, then kernel #16 (`ops/fused_adamw.py`), one launch that clips,
  updates both moments and applies the update to every parameter, with the
  learning rate read from the schedule at its count, as the JAX step reads
  `schedule(opt_state.count)`.  The clip is optax's scale
  min(1, max_norm / max(norm, 1e-16)) inside that pass, not the copy pass
  above; a parameter without a gradient is updated with a zero one, as in
  the JAX tree.

`TrainContext(..., mesh=create_mesh(data=1, seq=n))` runs its steps under
the mesh, as the JAX `TrainContext` does: the attention of every layer then
runs as ring attention over n sequence shards that live on the one device
(`ops/ring_kernel.py`); the context length must split over them.  The rest
of the step is unchanged, and the same converted weights load.

Not ported yet (NotImplementedError): `lora_only`, gradient accumulation,
EMA, FSDP, and a mesh whose 'seq' axis lies over the ranks of
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
from neko_tpu_torch.ops.fused_adamw import FusedAdamWState, fused_adamw_update
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
        "fsdp": fsdp,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"not yet ported to neko_tpu_torch training: {bad}")


def use_fused_adamw(cfg: OptimizerConfig) -> bool:
    """The fused path covers the plain AdamW train step (the JAX package
    keeps LoRA freezing and accumulation on the optax chain; here both raise
    before it matters)."""
    return (
        cfg.fused_adamw
        and not cfg.lora_only
        and cfg.gradient_accumulation_steps == 1
    )


class FusedAdamW(torch.optim.Optimizer):
    """AdamW with the clip inside one kernel pass (`ops/fused_adamw.py`).

    `state[p]` holds the fp32 moments "mu" and "nu" of each parameter and
    `state["count"]` the updates applied, shared by every parameter (both
    round-trip through `state_dict`).  `step()` reads the group's "lr"."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, max_norm: Optional[float] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, max_norm=max_norm))
        if len(self.param_groups) != 1:
            raise ValueError("FusedAdamW clips over one global norm: one parameter group")
        self.state["count"] = 0
        for p in self.param_groups[0]["params"]:
            self.state[p] = {"mu": torch.zeros_like(p, dtype=torch.float32),
                             "nu": torch.zeros_like(p, dtype=torch.float32)}

    @property
    def count(self) -> int:
        return self.state["count"]

    def fused_state(self) -> FusedAdamWState:
        """(count, mu, nu) in parameter order (views of the live moments)."""
        ps = self.param_groups[0]["params"]
        return FusedAdamWState(self.count, [self.state[p]["mu"] for p in ps],
                               [self.state[p]["nu"] for p in ps])

    def load_fused_state(self, st: FusedAdamWState) -> None:
        """Copy (count, mu, nu) in parameter order into the state."""
        ps = self.param_groups[0]["params"]
        if len(st.mu) != len(ps) or len(st.nu) != len(ps):
            raise ValueError(f"{len(st.mu)} moments for {len(ps)} parameters")
        for p, mu, nu in zip(ps, st.mu, st.nu):
            self.state[p]["mu"].copy_(mu)
            self.state[p]["nu"].copy_(nu)
        self.state["count"] = int(st.count)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        group = self.param_groups[0]
        ps = group["params"]
        b1, b2 = group["betas"]
        st = fused_adamw_update(
            ps, [p.grad for p in ps], self.fused_state(), lr=group["lr"], b1=b1, b2=b2,
            eps=group["eps"], wd=group["weight_decay"], max_norm=group["max_norm"])
        self.state["count"] = st.count


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
) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """-> (AdamW over `params`, schedule(update count) -> lr).  Every
    parameter is decayed, as the reference's torch AdamW does.  With
    `fused_adamw` the optimizer is `FusedAdamW`, which also clips."""
    kw = dict(lr=0.0, betas=(cfg.beta_1, cfg.beta_2), eps=cfg.adam_eps,
              weight_decay=cfg.weight_decay)
    if use_fused_adamw(cfg):
        opt = FusedAdamW(params, max_norm=None if cfg.disable_grad_clip else cfg.grad_norm_clip,
                         **kw)
    else:
        opt = torch.optim.AdamW(params, **kw)
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
    optimizer: torch.optim.Optimizer  # AdamW, or FusedAdamW
    seed: int
    # True from the optimizer update until `step` counts it: the parameters
    # may then be ahead of `step` (what a checkpoint must not be taken from)
    updating: bool = False


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

    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   fused_adamw_state: Optional[Dict] = None) -> TrainState:
        """Fresh state: the given weights, or random ones as the JAX package
        initializes them, drawn from numpy seeded with `seed`.  With
        `fused_adamw`, `fused_adamw_state` ({"count", "mu", "nu"}, the moments
        keyed as the state dict: `convert.jax_fused_adamw_state_to_torch`)
        starts the optimizer from those moments, and the step count from
        that count."""
        from neko_tpu_torch.convert import build_model, init_state_dict

        if state_dict is None:
            state_dict = init_state_dict(self.model_cfg, self.seed)
        model = build_model(self.model_cfg, state_dict, self.device)
        opt, _ = make_optimizer(self.opt_cfg, list(model.parameters()))
        step = 0
        if fused_adamw_state is not None:
            if not isinstance(opt, FusedAdamW):
                raise ValueError("fused_adamw_state needs OptimizerConfig(fused_adamw=True)")
            names = [n for n, _ in model.named_parameters()]
            opt.load_fused_state(FusedAdamWState(
                fused_adamw_state["count"], [fused_adamw_state["mu"][n] for n in names],
                [fused_adamw_state["nu"][n] for n in names]))
            step = opt.count
        return TrainState(step=step, model=model, optimizer=opt, seed=self.seed)

    def fused_adamw_state(self, state: TrainState) -> Dict:
        """{"count", "mu", "nu"} of a `FusedAdamW` state, the moments keyed
        as the state dict (what `init_state` takes back)."""
        st = state.optimizer.fused_state()
        names = [n for n, _ in state.model.named_parameters()]
        return {"count": st.count, "mu": dict(zip(names, st.mu)), "nu": dict(zip(names, st.nu))}

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
        the learning rate of this update, apply AdamW, count the step
        (`FusedAdamW` clips inside its own pass)."""
        with torch.profiler.record_function("optimizer"):
            fused = isinstance(state.optimizer, FusedAdamW)
            if not fused and not self.opt_cfg.disable_grad_clip:
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                clip_by_global_norm_(grads, self.opt_cfg.grad_norm_clip)
            # the update count before this update
            lr = self.schedule(state.optimizer.count if fused else state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.updating = True
            state.optimizer.step()
        state.step += 1
        state.updating = False

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: PackedBatch) -> torch.Tensor:
        """Deterministic loss on a batch (no grads, no dropout)."""
        with self.mesh or contextlib.nullcontext():
            _, loss = state.model(batch, compute_loss=True)
        return loss

    def current_lr(self, step: int) -> float:
        return self.schedule(step)
