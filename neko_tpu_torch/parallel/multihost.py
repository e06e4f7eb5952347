"""Processes of a training run (counterpart of neko_tpu/parallel/multihost.py).

* `process_info()`: (rank, world) of the initialised default process group,
  (0, 1) without one.
* `init_from_env(cpu)`: what the train CLI's `--multihost` does (the JAX
  package calls `jax.distributed.initialize()` there), and the serve and
  evaluation CLIs' `--mesh_model_axis N` (N > 1): joins the group that
  torchrun's environment describes (RANK, WORLD_SIZE, MASTER_ADDR,
  MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE) and picks the rank's device and
  the backend.  NCCL when every rank of the host has a card of its own
  (rank on card LOCAL_RANK); gloo with `--cpu`, or when the host's ranks
  outnumber its cards (they then share them, LOCAL_RANK modulo the count,
  and NCCL would refuse two ranks on one card; gloo carries the
  collectives of CUDA tensors through host memory).  The choice is
  printed.
* `host_seed` / `local_batch_size`: the JAX package's rules.  A process of
  the JAX package spans the 'model' devices of its host, so its process
  index is the data coordinate; here a process is one device, so the
  Trainer keys the sampling stream and the row count on the rank's 'data'
  coordinate (`data_info`): model peers draw the same rows.
* A rank's packed batch keeps local row indices (each rank feeds its model
  its own rows); the JAX package re-bases them to global rows
  (`globalize_arrays`) for its one global array.
* `eval_replica`: the canonical (one-process) state dict gathered from every
  rank's shards: a collective, every rank calls it (the counterpart of
  `eval_replica`, which forms the replica on the device the same way).
* `broadcast_object`: rank 0's value on every rank (the experiment name,
  a lockstep server's calls).
* `agree(flag, group)`: whether any rank raises `flag`, over a gloo group
  of its own with a timeout (`agree_group`), for the decisions of the
  emergency checkpoint, where a rank may be down; `tally` also says
  whether every rank does (a lockstep server's outcome of each call).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

def process_info() -> Tuple[int, int]:
    """(rank, world) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    return process_info()[0]


def process_count() -> int:
    return process_info()[1]


def data_info(mesh) -> Tuple[int, int]:
    """(this rank's 'data' coordinate, the axis size) of a mesh; (0, 1)
    without one.  What the batch rows and the sampling stream are keyed on."""
    if mesh is None:
        return 0, 1
    ax = mesh.axis("data")
    return ax.index, ax.size


def host_seed(seed: int, process_index: int = None) -> int:
    """Per-process sampling seed; process 0 keeps the user's seed."""
    if process_index is None:
        process_index = process_info()[0]
    return seed + process_index * 100_003


def local_batch_size(global_batch_size: int, process_count: int) -> int:
    """The per-process slice of the global batch."""
    if global_batch_size % process_count:
        raise ValueError(f"batch_size={global_batch_size} must be divisible by the "
                         f"number of data ranks ({process_count})")
    return global_batch_size // process_count


def choose_backend(cpu: bool, local_world: int, cards: int) -> str:
    """nccl when every rank of the host has a card of its own, else gloo."""
    if cpu or cards == 0:
        return "gloo"
    return "nccl" if local_world <= cards else "gloo"


def init_from_env(cpu: bool = False, flag: str = "--multihost") -> torch.device:
    """Join the process group torchrun's environment describes (see the
    module doc) and return this rank's device.  Prints the rank, the world,
    the device and the backend.  `flag`: the option that asked for the
    group, named when the environment is missing."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in env]
    if missing:
        raise ValueError(f"{flag} reads torchrun's environment; {missing} not set "
                         "(launch with torchrun, or set RANK, WORLD_SIZE, MASTER_ADDR and "
                         "MASTER_PORT for each process)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    cards = 0 if cpu else torch.cuda.device_count()
    if not cpu and cards == 0:
        raise SystemExit(f"{flag} on the card but no CUDA device is visible (pass --cpu "
                         "to run the ranks on the CPU)")
    backend = choose_backend(cpu, local_world, cards)
    device = torch.device("cpu") if cpu else torch.device("cuda", local_rank % cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            world_size=world, rank=rank)
    why = ("the CPU" if device.type == "cpu" else
           "a card for each rank" if backend == "nccl" else
           f"{local_world} ranks share {cards} card(s): gloo carries the collectives "
           "through host memory")
    print(f"[neko-tpu-torch] rank {rank}/{world} on {device}, backend {backend} ({why})",
          flush=True)
    return device


def eval_replica(ctx, state) -> Dict[str, torch.Tensor]:
    """The canonical state dict of `state`'s model on every rank (every rank
    must call this: it gathers the blocks and the pipeline's stages)."""
    return ctx.gather_named({n: p.detach() for n, p in state.model.named_parameters()})


def broadcast_object(obj, group=None):
    """Rank 0's `obj` on every rank of `group` (default: all; a
    collective); `obj` in one process."""
    if process_info()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def agree_group(timeout: float = 60.0):
    """A gloo group of every rank whose collectives give up after `timeout`
    seconds, for `agree`; None in one process.  Made while every rank is up
    (making it is itself collective)."""
    if process_info()[1] == 1:
        return None
    return dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=timeout))


def agree(flag: bool, group) -> Optional[bool]:
    """True when `flag` is True on any rank, False when on none, None when a
    rank did not join before the group's timeout.  One process (`group`
    None): `flag`."""
    both = tally(flag, group)
    return None if both is None else both[0]


def tally(flag: bool, group) -> Optional[Tuple[bool, bool]]:
    """(whether `flag` is True on any rank, on every rank) over an
    `agree_group`; None when a rank did not join before the group's
    timeout.  One process (`group` None): (`flag`, `flag`)."""
    if group is None:
        return flag, flag
    t = torch.tensor([1.0 if flag else 0.0, 0.0 if flag else 1.0])
    try:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    except RuntimeError:  # a rank is down or elsewhere: the timeout
        return None
    return bool(t[0] > 0), not bool(t[1] > 0)
