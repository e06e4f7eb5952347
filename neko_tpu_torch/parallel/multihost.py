"""One-process counterparts of neko_tpu/parallel/multihost.py.

The port trains in one process so far: `process_info` is (0, 1), and
`host_seed` / `local_batch_size` keep the JAX package's rules so that the
sampling streams match it.  A process group of more than one rank raises:
sharding the batch over processes is slice 5 of the port.
"""

from __future__ import annotations

import torch.distributed as dist


def process_info() -> tuple:
    """(process_index, process_count): (0, 1)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "training over several processes is not yet ported to neko_tpu_torch")
    return 0, 1


def process_index() -> int:
    return process_info()[0]


def process_count() -> int:
    return process_info()[1]


def host_seed(seed: int, process_index: int = None) -> int:
    """Per-host sampling seed; process 0 keeps the user's seed."""
    if process_index is None:
        process_index = process_info()[0]
    return seed + process_index * 100_003


def local_batch_size(global_batch_size: int, process_count: int) -> int:
    """The per-host slice of the global batch."""
    if global_batch_size % process_count:
        raise ValueError(f"batch_size={global_batch_size} must be divisible by the "
                         f"number of hosts ({process_count})")
    return global_batch_size // process_count
