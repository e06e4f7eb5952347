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

The JAX package's optimizer chain clip -> AdamW, wrapped by
`optax.multi_transform` under `lora_only` and by `optax.MultiSteps` under
gradient accumulation, with an EMA of the parameters beside it, is mirrored
so:

* `lora_only`: every parameter under `transformer` but `lora_a` / `lora_b`
  is frozen (no gradient, no update, no weight decay, no moments); the
  embeddings and heads train.  The global-norm clip counts the trained
  parameters only, as the clip inside `multi_transform` does.
* `gradient_accumulation_steps` k > 1: each call adds its gradients to a
  running mean (optax's acc + (g - acc) / (n + 1)); every k-th call the
  clip and AdamW run on the mean and the accumulator is cleared.
  `TrainState.step` counts calls; the schedule reads the update count,
  (step - mini_step) // k.  The accumulator and the mini-step are part of
  the state (and of checkpoints).
* `ema_decay` d > 0: after each update, ema = ema * d + p * (1 - d) in
  fp32 over every parameter, once per update (not per call) under k > 1.
  It runs after either optimizer route.

The fused route (`use_fused_adamw`) keeps the JAX package's gate: not under
`lora_only` or k > 1.

Over processes: `TrainContext(..., mesh=create_mesh(data, model), fsdp=)`
on an initialised process group computes what the JAX `TrainContext`
computes on a mesh of that shape (parallel/sharding.py has the layout):

* each rank's model holds its blocks of the parameters: heads, MLP width
  and vocabulary split over 'model' (the Megatron all-reduce pair a block,
  parallel/collectives.py), and with `fsdp` every large leaf split over
  'data' too, gathered at its use in the forward, its gradient
  reduce-scattered.  `init_state` takes the canonical state dict and keeps
  this rank's blocks; the optimizer's moments, the EMA and the accumulator
  are blocks of the same shape;
* the batch is this rank's rows (model peers take the same ones); the loss
  divides the rank's NLL sum by the target count of the global batch, so
  the gradients of the global masked mean are the SUM over 'data' of the
  ranks' (flat-bucket all-reduces of the leaves not split over 'data'), and
  the loss a step returns is that sum over 'data' of the ranks' parts; the
  gradients of the leaves replicated over 'model' are averaged there, so
  that the peers' copies stay equal whatever order a backward sums in;
* the global-norm clip (both optimizer routes) sums every rank's squares,
  each leaf's divided by the ranks holding a copy of it, so a replicated
  leaf counts once;
* the step's generator is keyed on the rank's 'data' coordinate, so data
  ranks draw independent masks and model peers identical ones (their
  replicated activations stay equal); the attention kernels add neko_tpu's
  per-axis seed offsets (models/policy.py `seed_offset`).

A 'seq' axis over ranks (`create_mesh(seq=n)` on a group): each rank runs
the model on its S / n columns of the whole rows its data coordinate packs
(models/policy.py), the attention as the ring over the 'seq' group; every
leaf is replicated over 'seq' and its gradient summed there, the loss's
target count is summed over 'data' and 'seq', and the step's generator is
shared by the 'seq' peers, whose dropout masks are the columns of one draw
(ops/dropout.py).

A 'pipe' axis (`create_mesh(pipe=n)`): each rank holds its stage's layers
and a copy of the root leaves (parallel/pipeline.py), and `loss_and_grads`
runs `OptimizerConfig.pipeline_schedule` ('gpipe' or '1f1b') over
`pipeline_microbatches` microbatches, as neko_tpu's TrainContext does on a
'pipe' mesh; the root leaves' gradients are summed over 'pipe' (stage 0
holds the embeddings', the last stage the head's), the clip's global norm
sums every stage's layers and counts the replicated leaves once.
`init_state` takes the canonical state dict and `gather_named` gives it
back (checkpoints, the evaluation replica), whatever the mesh.
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
from neko_tpu_torch.parallel import pipeline, sharding
from neko_tpu_torch.parallel.collectives import all_reduce_, all_reduce_grads_
from neko_tpu_torch.parallel.mesh import Mesh, axis, seq_axis_size
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


def use_fused_adamw(cfg: OptimizerConfig) -> bool:
    """The fused path covers the plain AdamW train step; LoRA freezing and
    accumulation stay on the AdamW route, as the JAX package keeps them on
    the optax chain."""
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
                 weight_decay: float = 0.0, max_norm: Optional[float] = None,
                 norm_fn: Optional[Callable] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, max_norm=max_norm))
        # the global gradient norm (None: the norm of this optimizer's grads;
        # over ranks, TrainContext's norm of the whole tree)
        self.norm_fn = norm_fn
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
        gnorm = None
        if group["max_norm"] is not None and self.norm_fn is not None:
            gnorm = self.norm_fn()
        st = fused_adamw_update(
            ps, [p.grad for p in ps], self.fused_state(), lr=group["lr"], b1=b1, b2=b2,
            eps=group["eps"], wd=group["weight_decay"], max_norm=group["max_norm"],
            gnorm=gnorm)
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
    cfg: OptimizerConfig, params: List[torch.nn.Parameter], norm_fn: Optional[Callable] = None,
) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """-> (AdamW over `params`, schedule(update count) -> lr).  Every
    parameter is decayed, as the reference's torch AdamW does.  With
    `fused_adamw` the optimizer is `FusedAdamW`, which also clips (to the
    norm `norm_fn()` returns, when given)."""
    kw = dict(lr=0.0, betas=(cfg.beta_1, cfg.beta_2), eps=cfg.adam_eps,
              weight_decay=cfg.weight_decay)
    if use_fused_adamw(cfg):
        opt = FusedAdamW(params, max_norm=None if cfg.disable_grad_clip else cfg.grad_norm_clip,
                         norm_fn=norm_fn, **kw)
    else:
        opt = torch.optim.AdamW(params, **kw)
    return opt, make_schedule(cfg)


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g -> g / norm * max_norm when the
    global norm is >= max_norm (the norm of `grads` unless given).  Returns
    the norm (a device scalar)."""
    if norm is None:
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


def lora_frozen(name: str) -> bool:
    """Whether `lora_only` freezes the parameter `name`: everything under
    the transformer but the LoRA adapters."""
    parts = name.split(".")
    return parts[0] == "transformer" and "lora_a" not in parts and "lora_b" not in parts


@dataclasses.dataclass
class TrainState:
    step: int                 # train_step calls
    model: NekoModel          # fp32 parameters on the device
    optimizer: torch.optim.Optimizer  # AdamW, or FusedAdamW
    seed: int
    # True from the optimizer update until `step` counts it: the parameters
    # may then be ahead of `step` (what a checkpoint must not be taken from)
    updating: bool = False
    # fp32 EMA of every parameter, keyed as the state dict (ema_decay > 0)
    ema: Optional[Dict[str, torch.Tensor]] = None
    # gradient accumulation (k > 1): the running mean of this window's
    # gradients, keyed by trained parameter name, and the calls in it
    accum: Optional[Dict[str, torch.Tensor]] = None
    mini_step: int = 0


class TrainContext:
    """Owns the model config, optimizer config, device and mesh; runs the
    steps."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: OptimizerConfig,
        device="cuda",
        seed: int = 0,
        fsdp: bool = False,
        mesh: Optional[Mesh] = None,
    ):
        n = seq_axis_size(mesh)
        if model_cfg.context_len % n:
            raise ValueError(f"context_len={model_cfg.context_len} does not split over "
                             f"the mesh's {n} sequence shards")
        self.mesh = mesh
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.device = torch.device(device)
        self.seed = seed
        self.fsdp = fsdp
        self.schedule = make_schedule(opt_cfg)
        # which block of each parameter this rank holds (all of it in one process)
        self.layout = sharding.model_layout(model_cfg, mesh, fsdp)
        self.data_axis = axis(mesh, "data")
        self.model_axis = axis(mesh, "model")
        self.seq_axis = axis(mesh, "seq")
        self.pipe_axis = axis(mesh, "pipe")
        if self.pipe_axis.on:
            pipeline.check(model_cfg, mesh, opt_cfg.pipeline_microbatches)
            if opt_cfg.pipeline_schedule not in ("gpipe", "1f1b"):
                raise ValueError(f"pipeline_schedule={opt_cfg.pipeline_schedule!r}: "
                                 "'gpipe' or '1f1b'")
        self.on_ranks = mesh is not None and mesh.on_ranks
        # the 1F1B schedule's readings of its last step (parallel/pipeline.py)
        self.last_schedule = None

    # ------------------------------------------------- canonical <-> blocks
    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the canonical tensor of parameter `name`."""
        if not self.on_ranks:
            return t
        return sharding.shard_tensor(t, name, self.layout[name], self.mesh)

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The canonical tensor of parameter `name` from every rank's block
        (a collective: every rank calls it with the same name)."""
        if not self.on_ranks:
            return t
        return sharding.gather_tensor(t, name, self.layout[name], self.mesh)

    def canonical_name(self, name: str) -> str:
        """The canonical name of this rank's parameter `name` (its stage's
        layer under its global index on a 'pipe' mesh)."""
        if not self.pipe_axis.on:
            return name
        return pipeline.canonical_key(name, self.model_cfg.layers, self.pipe_axis.size,
                                      self.pipe_axis.index)

    def gather_named(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The canonical tensors of this rank's `tensors` (keyed by its
        parameter names, in one order on every rank) from every rank's
        blocks and every stage's layers, keyed by canonical name (a
        collective)."""
        out = {n: self.gather(n, t) for n, t in tensors.items()}
        if not self.pipe_axis.on:
            return out
        n = self.pipe_axis.size
        stages: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
        for name, t in out.items():
            parts = (pipeline.gather_stages(t, self.mesh) if pipeline.is_stage_leaf(name)
                     else [t] * n)
            for p, part in enumerate(parts):
                stages[p][name] = part
        return pipeline.canonical_state_dict(stages, self.model_cfg)

    def shard_named(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's blocks of the canonical `tensors` it holds, keyed by
        its parameter names (the inverse of `gather_named`)."""
        if self.pipe_axis.on:
            tensors = pipeline.stage_state_dict(tensors, self.model_cfg.layers,
                                                self.pipe_axis.size, self.pipe_axis.index)
        return {n: self.shard(n, t) for n, t in tensors.items()}

    def _copies(self, name: str) -> int:
        """Ranks holding the same block of parameter `name` (its gradient
        norm is summed over 'data', 'model' and 'pipe')."""
        spec = self.layout[name]
        n = 1 if spec.data_dim is not None else self.data_axis.size
        n *= 1 if pipeline.is_stage_leaf(name) else self.pipe_axis.size
        return n * (1 if spec.model_dim is not None else self.model_axis.size)

    # ------------------------------------------------------------- state
    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   fused_adamw_state: Optional[Dict] = None) -> TrainState:
        """Fresh state: the given weights, or random ones as the JAX package
        initializes them, drawn from numpy seeded with `seed`.  With
        `fused_adamw`, `fused_adamw_state` ({"count", "mu", "nu"}, the moments
        keyed as the state dict: `convert.jax_fused_adamw_state_to_torch`)
        starts the optimizer from those moments, and the step count from
        that count.  Over ranks both are canonical, and the state holds this
        rank's blocks of them."""
        from neko_tpu_torch.convert import build_model, init_state_dict

        if state_dict is None:
            state_dict = init_state_dict(self.model_cfg, self.seed)
        model = build_model(self.model_cfg, state_dict, self.device, mesh=self.mesh,
                            specs=self.layout)
        trained = self.trained_parameters(model)
        if self.opt_cfg.lora_only:
            for n, p in model.named_parameters():
                p.requires_grad_(n in trained)
        norm_fn = (lambda: self.grad_norm(model)) if self.on_ranks else None
        opt, _ = make_optimizer(self.opt_cfg, list(trained.values()), norm_fn)
        ema = None
        if self.opt_cfg.ema_decay > 0.0:
            ema = {n: p.detach().to(torch.float32, copy=True)
                   for n, p in model.named_parameters()}
        accum = None
        if self.opt_cfg.gradient_accumulation_steps > 1:
            accum = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in trained.items()}
        step = 0
        if fused_adamw_state is not None:
            if not isinstance(opt, FusedAdamW):
                raise ValueError("fused_adamw_state needs OptimizerConfig(fused_adamw=True)")
            names = [n for n, _ in model.named_parameters()]
            mu, nu = (self.shard_named(fused_adamw_state[k]) for k in ("mu", "nu"))
            opt.load_fused_state(FusedAdamWState(
                fused_adamw_state["count"], [mu[n] for n in names], [nu[n] for n in names]))
            step = opt.count
        return TrainState(step=step, model=model, optimizer=opt, seed=self.seed, ema=ema,
                          accum=accum)

    def trained_parameters(self, model: NekoModel) -> Dict[str, torch.nn.Parameter]:
        """The parameters the optimizer updates, by name: all of them, or
        under `lora_only` all but the frozen transformer weights."""
        return {n: p for n, p in model.named_parameters()
                if not (self.opt_cfg.lora_only and lora_frozen(n))}

    def update_count(self, state: TrainState) -> int:
        """Optimizer updates applied: the schedule's count."""
        return (state.step - state.mini_step) // self.opt_cfg.gradient_accumulation_steps

    def fused_adamw_state(self, state: TrainState) -> Dict:
        """{"count", "mu", "nu"} of a `FusedAdamW` state, the moments keyed
        as the state dict (what `init_state` takes back; over ranks this
        rank's blocks)."""
        st = state.optimizer.fused_state()
        names = [n for n, _ in state.model.named_parameters()]
        return {"count": st.count, "mu": dict(zip(names, st.mu)), "nu": dict(zip(names, st.nu))}

    def step_seed(self, state: TrainState) -> int:
        """The step's seed, from (seed, step) and, over ranks, the rank's
        'data' coordinate: data ranks draw independent masks; model, 'seq'
        and 'pipe' peers the same ones."""
        return step_seed(state.seed + self.data_axis.index * 100_003, state.step)

    def step_generator(self, state: TrainState) -> torch.Generator:
        """The step's generator, seeded with `step_seed`."""
        return torch.Generator(device=self.device).manual_seed(self.step_seed(state))

    # ------------------------------------------------------------- steps
    def loss_and_grads(self, state: TrainState, batch: PackedBatch) -> torch.Tensor:
        """Train-mode loss of `batch` with the step's generator; leaves the
        gradients in the parameters' `.grad` (over ranks, the gradients of
        the global batch's loss).  -> this rank's part of the loss (device
        scalar; the global loss is its sum over 'data')."""
        loss = self.forward_backward(state, batch)
        self.sync_grads(state)
        return loss

    def forward_backward(self, state: TrainState, batch: PackedBatch) -> torch.Tensor:
        """`loss_and_grads` before `sync_grads`: each rank's own gradients."""
        state.optimizer.zero_grad(set_to_none=True)
        if self.pipe_axis.on:
            fn = (pipeline.pipelined_loss_1f1b if self.opt_cfg.pipeline_schedule == "1f1b"
                  else pipeline.pipelined_loss)
            with self.mesh:
                return fn(self, state.model, batch, self.step_generator(state),
                          self.step_seed(state))
        with self.mesh or contextlib.nullcontext():
            _, loss = state.model(batch, train=True, compute_loss=True,
                                  generator=self.step_generator(state))
        # the backward pass reads no mesh: each autograd node carries its own
        loss.backward()
        return loss.detach()

    def replicated_over_model(self, name: str) -> bool:
        return self.model_axis.on and self.layout[name].model_dim is None

    @torch.no_grad()
    def sync_grads(self, state: TrainState) -> None:
        """Sum over 'data' the gradients of the leaves not split there (the
        split ones were reduce-scattered in the backward), over 'seq' every
        gradient (each 'seq' rank's covers its columns), over 'pipe' the
        root leaves' (each stage computed its own part of them, the others
        none), and average over 'model' the gradients of the leaves
        replicated there: each peer computed the whole of it, and a backward
        that sums with atomics (the embeddings', the attention kernels')
        leaves the copies a rounding apart, which the mean removes, so the
        peers' copies stay equal."""
        if self.pipe_axis.on:  # a root leaf this stage did not use: a zero gradient
            for n, p in self.trained_parameters(state.model).items():
                if p.grad is None and not pipeline.is_stage_leaf(n):
                    p.grad = torch.zeros_like(p)
        named = [(n, p) for n, p in state.model.named_parameters() if p.grad is not None]
        if self.data_axis.on:
            all_reduce_grads_([p.grad for n, p in named if self.layout[n].data_dim is None],
                              self.data_axis)
        all_reduce_grads_([p.grad for _, p in named], self.seq_axis)
        all_reduce_grads_([p.grad for n, p in named if not pipeline.is_stage_leaf(n)],
                          self.pipe_axis)
        if self.model_axis.on:
            grads = [p.grad for n, p in named if self.replicated_over_model(n)]
            if grads:
                all_reduce_grads_(grads, self.model_axis)
                torch._foreach_mul_(grads, 1.0 / self.model_axis.size)

    @torch.no_grad()
    def grad_norm(self, model: NekoModel) -> torch.Tensor:
        """The global norm of the whole tree's gradients from this rank's
        blocks: the sum over every rank of each leaf's squares divided by
        the ranks holding a copy of it (a collective)."""
        sq = [torch.linalg.vector_norm(p.grad, dtype=torch.float32) ** 2 / self._copies(n)
              for n, p in self.trained_parameters(model).items() if p.grad is not None]
        total = torch.stack(sq).sum().reshape(1)
        for ax in (self.data_axis, self.model_axis, self.pipe_axis):
            all_reduce_(total, ax)
        return total[0].sqrt()

    def global_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """A rank's part of the loss summed over 'data', 'seq' and 'pipe'
        (the loss itself in one process)."""
        axes = [ax for ax in (self.data_axis, self.seq_axis, self.pipe_axis) if ax.on]
        if not axes:
            return loss
        total = loss.reshape(1).clone()
        for ax in axes:
            all_reduce_(total, ax)
        return total[0]

    def train_step(self, state: TrainState, batch: PackedBatch):
        """One call in place: an optimizer step, or under gradient
        accumulation one mini-step (an update every k-th).  -> (state,
        loss as a device scalar: reading it is the caller's choice, the
        step never syncs; over ranks the global batch's loss)."""
        loss = self.loss_and_grads(state, batch)
        self.apply_gradients(state)
        return state, self.global_loss(loss)

    @torch.no_grad()
    def _accumulate(self, state: TrainState) -> bool:
        """Fold this call's `.grad` into the running mean (optax.MultiSteps:
        acc + (g - acc) / (n + 1); a parameter without a gradient adds a
        zero one).  -> True when the window is full: `.grad` then holds the
        mean and the accumulator is cleared."""
        n = state.mini_step
        emit = n == self.opt_cfg.gradient_accumulation_steps - 1
        for name, p in self.trained_parameters(state.model).items():
            acc = state.accum[name]
            g = torch.zeros_like(acc) if p.grad is None else p.grad
            acc.add_((g - acc) / (n + 1))
            if emit:
                p.grad = acc.clone()
                acc.zero_()
        state.mini_step = 0 if emit else n + 1
        return emit

    @torch.no_grad()
    def _update_ema(self, state: TrainState) -> None:
        """ema = ema * d + p * (1 - d) over the tree, in multi-tensor passes."""
        d = self.opt_cfg.ema_decay
        names, ps = zip(*((n, p.detach().float()) for n, p in state.model.named_parameters()))
        emas = [state.ema[n] for n in names]
        torch._foreach_mul_(emas, d)
        torch._foreach_add_(emas, torch._foreach_mul(ps, 1.0 - d))

    def apply_gradients(self, state: TrainState) -> None:
        """The optimizer half of a call: under accumulation fold the
        gradients in and stop unless the window is full; else clip the
        gradients in `.grad`, set the learning rate of this update, apply
        AdamW (`FusedAdamW` clips inside its own pass), update the EMA;
        count the call."""
        with torch.profiler.record_function("optimizer"):
            if state.accum is not None and not self._accumulate(state):
                state.step += 1
                return
            fused = isinstance(state.optimizer, FusedAdamW)
            if not fused and not self.opt_cfg.disable_grad_clip:
                grads = [p.grad for p in state.model.parameters() if p.grad is not None]
                norm = self.grad_norm(state.model) if self.on_ranks else None
                clip_by_global_norm_(grads, self.opt_cfg.grad_norm_clip, norm)
            # the update count before this update
            lr = self.schedule(state.optimizer.count if fused else self.update_count(state))
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.updating = True
            state.optimizer.step()
            if state.ema is not None:
                self._update_ema(state)
        state.step += 1
        state.updating = False

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: PackedBatch) -> torch.Tensor:
        """Deterministic loss on a batch (no grads, no dropout; over ranks
        the global batch's)."""
        if self.pipe_axis.on:  # the GPipe forward, no backward
            with self.mesh:
                loss = pipeline.pipelined_loss(self, state.model, batch, backward=False)
        else:
            with self.mesh or contextlib.nullcontext():
                _, loss = state.model(batch, compute_loss=True)
        return self.global_loss(loss)

    def current_lr(self, step: int) -> float:
        """The learning rate at update count `step`."""
        return self.schedule(step)
