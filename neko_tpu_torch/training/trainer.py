"""Training orchestration: mixture sampling, train / eval cadence,
checkpoints (counterpart of neko_tpu/training/trainer.py).

* `train()` runs (training_steps - steps) // log_eval_freq iterations of
  log_eval_freq steps, then the remainder, each followed by evaluation,
  logging and (with `--save_mode checkpoint`) a checkpoint; any exception
  leaves an emergency checkpoint first (with `--save_model`).
* each step's batch is split over text / caption / VQA / control by
  `text_prop`, `caption_prop` and `vqa_prop`, with the remainder handed to
  one component by a multinomial over the fractional residuals; the
  control rows go to the tasks round-robin without
  replacement, a `prompt_ep_proportion` share of them prompted, half 'end'
  and half 'uniform'.
* the examples are packed on the host into one static-shape batch with the
  worst-case patch pool and loss-target budgets of the mixture, so every
  step has the same shapes; a prefetch thread samples, packs and copies the
  next batches to the device while the step runs (data/pipeline.py).
* exact resume: the host RNG state right after each batch is sampled rides
  the prefetch queue with it, and the state of the batch consumed at step N
  is written beside checkpoint_N (utils/host_state.py).  No emergency
  checkpoint is taken from a state torn between the optimizer update and
  the step count, or between the step and its host state: the last
  checkpoint stands.
* evaluation runs from an activation-dtype copy of the weights that it
  refreshes each time (`Generator.set_params`), never from the fp32
  training parameters, under the sampling lock (the tasks' RNGs are shared
  with the prefetch thread).

* `--profile_dir DIR` traces steps [2, 2 + profile_steps) with
  torch.profiler (CPU and, on the card, CUDA activities; each step a
  "train_step" range) and writes the Chrome trace
  `DIR/trace_p<process>.json`; the other steps run without the profiler.

Over ranks (a context whose mesh spans a process group): each rank samples
and packs batch_size / data rows, from a stream seeded by its 'data'
coordinate (`host_seed(seed, d)`, the JAX package's per-host rule: model,
'seq' and 'pipe' peers take the same rows; a 'seq' rank keeps its columns
on the device), with local row indices.  Rank 0 logs and writes
the experiment files; evaluation runs on rank 0 from the canonical weights
that every rank helps gather (`multihost.eval_replica`), the others return
no metrics.  A checkpoint is gathered by every rank and written by rank 0,
and every rank writes its host-state sidecar.  The emergency checkpoint is
taken only when every rank answers within `EMERGENCY_TIMEOUT` seconds and
none is torn (`multihost.agree`); otherwise no rank writes anything.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from neko_tpu_torch.data.batch import to_device_batch
from neko_tpu_torch.data.packing import SequencePacker
from neko_tpu_torch.parallel import multihost as mh
from neko_tpu_torch.tasks.base import Task
from neko_tpu_torch.tasks.control import ControlTask
from neko_tpu_torch.tasks.text import TextTask
from neko_tpu_torch.training.arguments import resolve_parallel_episodes
from neko_tpu_torch.training.train_state import TrainContext, TrainState
from neko_tpu_torch.utils import host_state as hs
from neko_tpu_torch.utils.checkpoint import save_checkpoint
from neko_tpu_torch.utils.logging import MetricsLogger

# seconds the ranks wait for each other before an emergency checkpoint
EMERGENCY_TIMEOUT = 60.0


class Trainer:
    def __init__(
        self,
        ctx: TrainContext,
        tasks: List[Task],
        exp_name: str,
        args,
        logger: Optional[MetricsLogger] = None,
    ):
        if args.save_model and args.prefetch_workers > 1 and args.prefetch_batches > 0:
            raise ValueError(
                f"--save_model with --prefetch_workers {args.prefetch_workers}: with more "
                "than one prefetch worker the batch order depends on thread scheduling, so "
                "a checkpoint's host state could not replay it; use --prefetch_workers 1")
        self.ctx = ctx
        self.tasks = tasks
        self.args = args
        self.exp_name = exp_name
        self.exp_dir = os.path.join(args.save_dir, exp_name)
        self.packer = SequencePacker(ctx.model_cfg)
        # the rank (host-state sidecars, rank 0's duties) and the 'data'
        # coordinate (the batch rows and the sampling stream)
        self.proc_index, self.proc_count = mh.process_info()
        self.data_index, self.data_count = mh.data_info(ctx.mesh)
        self.is_main_process = self.proc_index == 0
        self.local_batch_size = mh.local_batch_size(args.batch_size, self.data_count)
        self.logger = logger or MetricsLogger(
            exp_dir=(self.exp_dir if (args.save_model or args.log_jsonl) and self.is_main_process
                     else None),
            use_wandb=args.use_wandb and self.is_main_process,
            print_logs=self.is_main_process, jsonl=args.log_jsonl)
        self.rng = np.random.default_rng(mh.host_seed(args.seed, self.data_index))
        self._agree_group = mh.agree_group(EMERGENCY_TIMEOUT)
        self.deterministic = args.eval_mode == "deterministic"
        self.steps = 0
        self.state: Optional[TrainState] = None
        self.start_time = None
        self.control_tasks = [t for t in tasks if isinstance(t, ControlTask)]
        self.text_tasks = [t for t in tasks if isinstance(t, TextTask)]
        # caption / VQA tasks are matched by their task_kind
        self.caption_tasks = [t for t in tasks if getattr(t, "task_kind", "") == "caption"]
        self.vqa_tasks = [t for t in tasks if getattr(t, "task_kind", "") == "vqa"]
        self.patch_budget = self._compute_patch_budget()
        self.target_budget = self._compute_target_budget()
        self._prefetcher = None
        self._profiler = None
        self._generator = None
        # host state right after sampling the batch most recently consumed
        # by train_step: what a checkpoint persists (the live RNGs run ahead
        # of it by the prefetch depth)
        self._host_snapshot = None
        # the prefetch thread and evaluation share the tasks' RNGs
        self._sample_lock = threading.Lock()

    # ------------------------------------------------------------- budgets
    def _component_counts(self):
        """Base per-component row counts and the residual remainder, which
        `_mixture_sizes` hands to exactly one component a step."""
        bs, a = self.local_batch_size, self.args
        base = {"text": int(a.text_prop * bs) if self.text_tasks else 0,
                "caption": int(a.caption_prop * bs) if self.caption_tasks else 0,
                "vqa": int(a.vqa_prop * bs) if self.vqa_tasks else 0}
        control_prop = 1 - a.text_prop - a.caption_prop - a.vqa_prop
        base["control"] = int(control_prop * bs) if self.control_tasks else 0
        return base, bs - sum(base.values())

    def _has_tasks(self, component: str) -> bool:
        return bool({"text": self.text_tasks, "caption": self.caption_tasks,
                     "vqa": self.vqa_tasks, "control": self.control_tasks}[component])

    def _compute_patch_budget(self) -> int:
        """Worst-case image patches in one mixture batch (constant across
        steps, so every step has the same shapes), rounded up to 256."""
        base, remainder = self._component_counts()
        per_row = {"text": 0, "control": max(
            [t.required_patches for t in self.control_tasks], default=0),
            "caption": max([t.patches_per_image for t in self.caption_tasks], default=0),
            "vqa": max([t.patches_per_image for t in self.vqa_tasks], default=0)}
        # the remainder lands on one component: take the costliest recipient
        budget = sum(base[c] * per_row[c] for c in base) + remainder * max(per_row.values())
        return 0 if budget == 0 else -(-budget // 256) * 256

    def _compute_target_budget(self) -> int:
        """Worst-case loss targets a batch (the gathered loss); 0 selects the
        loss without gathered targets."""
        bs, S = self.local_batch_size, self.args.sequence_length
        base, remainder = self._component_counts()
        per_row = {"text": S - 1, "caption": 0, "vqa": 0, "control": 0}
        if self.control_tasks:
            per_row["control"] = max(
                t.context_timesteps * (t.action_tokens + (
                    t.observation_tokens if self.args.observation_loss else 0))
                for t in self.control_tasks)
        for key, tasks in (("caption", self.caption_tasks), ("vqa", self.vqa_tasks)):
            if tasks:
                per_row[key] = max(S - t.patches_per_image - 1 for t in tasks)
        budget = sum(base[c] * per_row[c] for c in base if self._has_tasks(c))
        budget += remainder * max((per_row[c] for c in base if self._has_tasks(c)), default=0)
        budget = -(-budget // 256) * 256
        return 0 if budget >= bs * S else budget

    # ----------------------------------------------------------- lifecycle
    def init_state(self, state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """The train state from `state_dict` (random weights from the seed
        when None).  One batch is sampled first, as the JAX Trainer samples
        the batch it traces the model with, so the data stream that follows
        is the JAX package's."""
        self.sample_arrays()
        self.state = self.ctx.init_state(state_dict)
        self._host_snapshot = (self.state.step, self.host_state())

    def train(self):
        self.start_time = time.time()
        if self.state is None:
            self.init_state()
        # the REMAINING steps: a run resumed at step N ends at training_steps
        remaining = max(0, self.args.training_steps - self.steps)
        iters, tail = divmod(remaining, self.args.log_eval_freq)
        try:
            for i in range(iters):
                logs = self.train_iteration(self.args.log_eval_freq, i)
                self.logger.log(logs, step=self.steps, header=f"Iteration {i}")
            if tail:
                logs = self.train_iteration(tail, iters)
                self.logger.log(logs, step=self.steps, header=f"Iteration {iters}")
            if self.args.save_model and self.args.save_mode == "last":
                self._save()
        except BaseException:
            # preemption / failure: persist the state so --resume_from
            # continues exactly, then re-raise
            if self.args.save_model and self.state is not None:
                torn = self._torn()
                verdict = mh.agree(torn is not None, self._agree_group)
                if verdict is None:
                    print(f"[neko-tpu-torch] no emergency checkpoint: a rank did not answer "
                          f"within {EMERGENCY_TIMEOUT} s; --resume_from the last checkpoint")
                elif verdict:
                    print(f"[neko-tpu-torch] no emergency checkpoint: "
                          f"{torn or 'another rank is torn'}; --resume_from the last checkpoint")
                else:
                    try:
                        print(f"[neko-tpu-torch] emergency checkpoint: {self._save()}")
                    except Exception as e:  # noqa: BLE001 -- the original error matters more
                        print(f"[neko-tpu-torch] emergency checkpoint failed: {e!r}")
            raise
        finally:
            if self._profiler is not None:
                self._stop_profile()
            if self._prefetcher is not None:
                self._prefetcher.close()
                self._prefetcher = None

    def train_iteration(self, num_steps: int, it: int) -> Dict:
        logs: Dict = {}
        train_start = time.time()
        losses = []
        step_logs: Dict = {}
        for _ in range(num_steps):
            self.steps += 1
            loss, step_logs = self.train_step()
            losses.append(loss)
        losses = [float(x) for x in losses]  # waits for the last step
        logs.update(step_logs)
        train_time = time.time() - train_start
        logs["time/training"] = train_time
        logs["training/tokens_per_sec"] = (
            num_steps * self.args.batch_size * self.args.sequence_length
            / max(train_time, 1e-9))
        eval_start = time.time()
        logs.update(self.evaluate())
        logs["time/total"] = time.time() - self.start_time
        logs["time/evaluation"] = time.time() - eval_start
        logs["training/train_loss_mean"] = float(np.mean(losses))
        logs["training/train_loss_std"] = float(np.std(losses))
        if self.args.save_model and self.args.save_mode == "checkpoint":
            self._save()
        return logs

    # ------------------------------------------------------------ training
    def _mixture_sizes(self) -> Dict[str, int]:
        bs = self.local_batch_size
        text_prop, caption_prop, vqa_prop = (
            self.args.text_prop, self.args.caption_prop, self.args.vqa_prop)
        control_prop = 1 - text_prop - caption_prop - vqa_prop
        sizes = {"text": int(text_prop * bs), "caption": int(caption_prop * bs),
                 "vqa": int(vqa_prop * bs), "control": int(control_prop * bs)}
        remainder = bs - sum(sizes.values())
        if remainder > 0:
            residuals = np.array([text_prop * bs - sizes["text"],
                                  caption_prop * bs - sizes["caption"],
                                  vqa_prop * bs - sizes["vqa"],
                                  control_prop * bs - sizes["control"]])
            total = residuals.sum()
            probs = residuals / total if total > 0 else np.ones(4) / 4
            idx = self.rng.choice(4, p=probs)
            sizes[["text", "caption", "vqa", "control"][idx]] += remainder
        return sizes

    def host_state(self):
        """Current host data-stream state (trainer RNG + per-task RNGs)."""
        return hs.collect(self.rng, self.tasks)

    def load_host_state(self, snapshot) -> None:
        """Restore the host stream of the current state's step."""
        hs.restore(snapshot, self.rng, self.tasks)
        self._host_snapshot = (self.state.step, snapshot)

    def _torn(self) -> Optional[str]:
        """Why the state cannot be checkpointed as one step, or None.  An
        interrupt inside the optimizer update leaves parameters ahead of the
        step count; one between the step and the commit of its host state
        leaves the host state a step behind."""
        if self.state.updating:
            return (f"stopped inside the optimizer update of step {self.state.step + 1}, "
                    "the parameters may be ahead of the step count")
        if self._host_snapshot is not None and self._host_snapshot[0] != self.state.step:
            return f"the host state of step {self.state.step} was not committed"
        return None

    def _checkpoint_host_state(self):
        """The host state right after sampling the batch of the current
        step (the live state where none was recorded)."""
        if self._host_snapshot is not None:
            return self._host_snapshot[1]
        with self._sample_lock:
            return self.host_state()

    def _save(self) -> str:
        # named by the steps the state has taken: an interrupt inside step N
        # leaves N - 1 (the JAX Trainer names that checkpoint N)
        step = self.state.step
        path = save_checkpoint(self.exp_dir, self.state, step, self.args, self.ctx)
        hs.save_host_state(self.exp_dir, step, self._checkpoint_host_state(), self.proc_index)
        return path

    def sample_arrays(self):
        """Sample the task mixture and pack it into host numpy arrays."""
        with self._sample_lock:
            return self._sample_arrays_locked()

    def _sample_arrays_locked(self):
        sizes = self._mixture_sizes()
        examples: List[Dict] = []
        for kind, tasks in (("text", self.text_tasks), ("caption", self.caption_tasks),
                            ("vqa", self.vqa_tasks)):
            if sizes[kind] > 0:
                for task in tasks:
                    examples += task.sample_batch(sizes[kind])
        if sizes["control"] > 0:
            examples += self.sample_control_batch(sizes["control"])
        arrays = self.packer.pack_batch(examples, patch_budget=self.patch_budget,
                                        target_budget=self.target_budget)
        arrays.pop("lengths")
        return arrays

    def build_batch(self, arrays):
        """The packed arrays as a batch on the device; the copy is
        non-blocking from pinned memory on a CUDA device."""
        return to_device_batch(arrays, self.ctx.device, non_blocking=True)

    def _produce_batch(self):
        """(device batch, host state right after sampling it): the unit the
        prefetch queue carries."""
        with self._sample_lock:
            arrays = self._sample_arrays_locked()
            snapshot = self.host_state()
        return self.build_batch(arrays), snapshot

    def _next_batch(self):
        depth = self.args.prefetch_batches
        if depth <= 0:  # the copy runs on this thread's stream
            return self._produce_batch()
        if self._prefetcher is None:
            from neko_tpu_torch.data.pipeline import HostPrefetcher

            self._prefetcher = HostPrefetcher(self._produce_batch, depth=depth,
                                              workers=self.args.prefetch_workers,
                                              device=self.ctx.device)
        return self._prefetcher.get()

    def train_step(self):
        # the schedule advances per optimizer update: under gradient
        # accumulation the update of every k-th call
        accum = max(1, self.args.gradient_accumulation_steps)
        logs: Dict = {"training/learning_rate": self.ctx.current_lr(
            max(0, self.steps - 1) // accum)}
        t0 = time.time()
        batch, pending_snapshot = self._next_batch()
        # with prefetch this is the queue wait: ~0 while the host keeps up
        logs["time/sample_batch"] = time.time() - t0
        if self._prefetcher is not None:
            logs["time/host_pipeline"] = self._prefetcher.last_produce_time
        self._maybe_profile()
        with torch.profiler.record_function("train_step"):
            self.state, loss = self.ctx.train_step(self.state, batch)
        # commit after the step: an interrupt mid-step leaves the snapshot at
        # the previous batch, so resume replays the batch never applied
        self._host_snapshot = (self.state.step, pending_snapshot)
        return loss, logs

    def _maybe_profile(self) -> None:
        """Start the profiler before step 2, stop it before step
        2 + profile_steps (`--profile_dir`)."""
        if not self.args.profile_dir:
            return
        if self.steps == 2 and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.ctx.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.start()
        elif self._profiler is not None and self.steps == 2 + self.args.profile_steps:
            self._stop_profile()

    def _stop_profile(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir, f"trace_p{self.proc_index}.json")
        prof.export_chrome_trace(path)
        print(f"[neko-tpu-torch] profiler trace written to {path}")

    def sample_control_batch(self, batch_size: int) -> List[Dict]:
        tasks = self.control_tasks
        n_tasks = len(tasks)
        if n_tasks == 0:
            raise ValueError("control batch requested but no control tasks")
        sampled: List[int] = []
        while len(sampled) < batch_size:
            take = min(n_tasks, batch_size - len(sampled))
            sampled += list(self.rng.choice(n_tasks, size=take, replace=False))
        n_prompted = round(batch_size * self.args.prompt_ep_proportion)
        prompt_slots = list(self.rng.choice(batch_size, size=n_prompted, replace=False))
        end_slots = set(
            self.rng.choice(prompt_slots, size=round(len(prompt_slots) / 2), replace=False)
            if prompt_slots else [])
        uniform_slots = set(s for s in prompt_slots if s not in end_slots)
        out: List[Dict] = []
        for i, task in enumerate(tasks):
            vanilla = 0
            prompted: Dict[str, int] = {}
            for slot, task_idx in enumerate(sampled):
                if task_idx != i:
                    continue
                if slot in end_slots:
                    prompted["end"] = prompted.get("end", 0) + 1
                elif slot in uniform_slots:
                    prompted["uniform"] = prompted.get("uniform", 0) + 1
                else:
                    vanilla += 1
            if vanilla + sum(prompted.values()) > 0:
                out += task.sample_batch(vanilla, prompted,
                                         max_tokens=self.args.sequence_length)
        return out

    # ---------------------------------------------------------- evaluation
    def _eval_generator(self, weights):
        """The Generator over the activation-dtype copy, refreshed from the
        training weights (which it reads, never changes)."""
        from neko_tpu_torch.convert import build_model
        from neko_tpu_torch.inference.generator import Generator

        if self._generator is None:
            dtype = self.ctx.model_cfg.activation_dtype
            copy = {k: v.detach().to(dtype, copy=True) for k, v in weights.items()}
            self._generator = Generator(
                build_model(self.ctx.model_cfg, copy, self.ctx.device), self.packer)
        else:
            self._generator.set_params(weights)
        return self._generator

    def evaluate(self) -> Dict:
        if not any(eval_count(task, self.args)[1] > 0 for task in self.tasks):
            return {}  # no copy of the weights when nothing is evaluated
        if self.ctx.on_ranks:
            # the canonical weights, gathered by every rank (a collective);
            # rank 0 evaluates them
            weights = mh.eval_replica(self.ctx, self.state)
            if not self.is_main_process:
                return {}
        else:
            weights = self.state.model.state_dict()
        gen = self._eval_generator(weights)
        with self._sample_lock:
            logs: Dict = {}
            for task in self.tasks:
                logs.update(evaluate_task(task, gen, self.args, self.deterministic))
            return logs


def eval_count(task, args):
    """(log prefix, examples or episodes to evaluate) of a task under the
    args; a count of 0 skips the task."""
    if isinstance(task, ControlTask):
        return task.name, args.eval_episodes
    if isinstance(task, TextTask):
        return "text", args.eval_text_num_examples
    kind = getattr(task, "task_kind", "")
    if kind == "caption":
        return "caption", args.eval_caption_num_examples
    if kind == "vqa":
        return "VQA", args.eval_vqa_num_examples
    return kind, 0


def evaluate_task(task, gen, args, deterministic: bool,
                  parallel_episodes: Optional[int] = None) -> Dict:
    """One task's `evaluation/<prefix>/<metric>` logs through `gen`.
    `parallel_episodes` overrides the args' lockstep width (control)."""
    prefix, n = eval_count(task, args)
    if n <= 0:
        return {}
    if isinstance(task, ControlTask):
        if parallel_episodes is None:
            parallel_episodes = resolve_parallel_episodes(args.eval_parallel_episodes, n)
        m = task.evaluate(gen, n_iterations=n, deterministic=deterministic,
                          promptless_eval=args.promptless_eval,
                          parallel_episodes=parallel_episodes)
    else:
        log = {"text": args.eval_text_log_examples, "caption": args.eval_caption_log_examples,
               "VQA": args.eval_vqa_log_examples}[prefix]
        m = task.evaluate(gen, num_examples_to_test=n, deterministic=deterministic,
                          log_examples_to_output=log)
    return {f"evaluation/{prefix}/{k}": v for k, v in m.items()}
