"""Host data-stream state (counterpart of neko_tpu/utils/host_state.py):
capture and restore of every numpy RNG that feeds training-batch sampling,
so `--resume_from` replays the uninterrupted run's example stream bit for
bit.

The Trainer snapshots this state right after sampling each batch (inside
the sampling lock, carried through the prefetch queue), and the snapshot of
the batch consumed at step N is written beside checkpoint_N as
`host_state_<N>_p<proc>.pkl`, with the JAX package's content: the trainer's
mixture RNG and each task's sampling RNG.  Evaluation draws from separate
`eval_rng` streams and the episode stores have no cursor, so this is the
whole host stream state.

Two cases cannot be replayed, and the port refuses them instead of resuming
approximately in silence: several prefetch workers (the batch order depends
on scheduling; `Trainer` refuses `--save_model` with them), and sidecars
written by another number of processes (`load_host_state_for` raises).
"""

from __future__ import annotations

import copy
import os
import pickle
import re
from typing import Any, Dict, List, Optional

import numpy as np


def rng_state(rng) -> Dict[str, Any]:
    """Picklable state of a np.random.Generator or legacy RandomState."""
    if isinstance(rng, np.random.Generator):
        return {"kind": "generator", "state": copy.deepcopy(rng.bit_generator.state)}
    if isinstance(rng, np.random.RandomState):
        return {"kind": "random_state", "state": copy.deepcopy(rng.get_state())}
    raise TypeError(f"unsupported RNG type {type(rng)!r}")


def set_rng_state(rng, state: Dict[str, Any]) -> None:
    if isinstance(rng, np.random.Generator) and state["kind"] == "generator":
        rng.bit_generator.state = state["state"]
    elif isinstance(rng, np.random.RandomState) and state["kind"] == "random_state":
        rng.set_state(state["state"])
    else:
        raise TypeError(f"cannot restore a {state['kind']} state into {type(rng)!r}")


def collect(trainer_rng, tasks: List) -> Dict[str, Any]:
    """Snapshot the trainer RNG + every task's training-sampling state."""
    return {
        "version": 1,
        "trainer_rng": rng_state(trainer_rng),
        "tasks": [{"name": getattr(t, "name", "task"), "state": t.host_state()}
                  for t in tasks],
    }


def restore(snapshot: Dict[str, Any], trainer_rng, tasks: List) -> None:
    saved = snapshot["tasks"]
    if len(saved) != len(tasks):
        raise ValueError(f"checkpoint has {len(saved)} task states but the run builds "
                         f"{len(tasks)} tasks: resume with the same task configuration")
    for entry, task in zip(saved, tasks):
        if entry["name"] != getattr(task, "name", "task"):
            raise ValueError(f"task order differs on resume: checkpoint {entry['name']!r}, "
                             f"run {getattr(task, 'name', 'task')!r}")
    set_rng_state(trainer_rng, snapshot["trainer_rng"])
    for entry, task in zip(saved, tasks):
        task.load_host_state(entry["state"])


def _host_file(exp_dir: str, step: int, proc_index: int) -> str:
    return os.path.join(exp_dir, f"host_state_{step}_p{proc_index}.pkl")


def save_host_state(exp_dir: str, step: int, snapshot: Dict[str, Any],
                    proc_index: int = 0) -> str:
    os.makedirs(exp_dir, exist_ok=True)
    path = _host_file(exp_dir, step, proc_index)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(snapshot, fh)
    os.replace(tmp, path)
    return path


def load_host_state_for(checkpoint_path: str, proc_index: int = 0,
                        proc_count: int = 1) -> Optional[Dict[str, Any]]:
    """The sidecar of a checkpoint_<N> dir for this process, or None when
    the checkpoint has none (the resume is then approximate).  Raises when
    the sidecars present were written by another number of processes."""
    base = os.path.basename(os.path.normpath(checkpoint_path))
    m = re.fullmatch(r"checkpoint_(\d+)", base)
    if m is None:
        return None
    step = int(m.group(1))
    exp_dir = os.path.dirname(os.path.abspath(os.path.normpath(checkpoint_path)))
    procs = sorted(
        int(mm.group(1)) for name in os.listdir(exp_dir)
        if (mm := re.fullmatch(rf"host_state_{step}_p(\d+)\.pkl", name)))
    if not procs:
        return None
    if procs != list(range(proc_count)):
        raise ValueError(
            f"{checkpoint_path}: its host_state sidecars were written by "
            f"{len(procs)} process(es) (p{procs}), this run has {proc_count}: the "
            "sampling streams are per process, so the data stream cannot be replayed; "
            "resume with the same process count")
    with open(_host_file(exp_dir, step, proc_index), "rb") as fh:
        return pickle.load(fh)
