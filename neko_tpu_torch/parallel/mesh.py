"""The device mesh of the port (counterpart of neko_tpu/parallel/mesh.py).

The JAX package names its parallelism by mesh axes: batch on 'data', heads
and MLP width on 'model', the sequence on 'seq' (ring attention), pipeline
stages on 'pipe'.  The port keeps the names and, so far, carries the 'seq'
axis: `create_mesh(data=1, seq=n)` gives a mesh whose sequence axis has n
shards, and inside `with mesh:` the train-mode attention runs as ring
attention over them (ops/attention.py reads `active_mesh()`).

A mesh says how its 'seq' axis is laid out:

* `seq_group is None`: the n shards are the n consecutive S / n-row blocks of
  tensors that live whole on the current device.  The ring schedule walks
  them in place (views, no copies).  This is the default when
  `torch.distributed` is not initialised, and what one card runs.
* `seq_group` a process group: rank r of the group holds shard r, and kv
  blocks travel to rank + 1 with `torch.distributed` point-to-point calls.
  The default when `torch.distributed` is initialised (the default group;
  its size must equal `seq`).

Tensor parallelism ('model'), pipeline parallelism ('pipe') and data
parallelism ('data') over processes are not ported yet: asking for them
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

_active = threading.local()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, and the process group of the 'seq' axis (None:
    the shards live on the current device).  `with mesh:` makes it the
    active mesh of the thread."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    seq_group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def __enter__(self) -> "Mesh":
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active.stack.pop()


def active_mesh() -> Optional[Mesh]:
    """The innermost `with mesh:` of this thread, or None."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


def create_mesh(
    data: Optional[int] = None,
    model: int = 1,
    seq: int = 1,
    pipe: int = 1,
    *,
    seq_group: Any = "auto",
) -> Mesh:
    """Build a ('data', 'seq', 'model') mesh.

    `seq` > 1 enables sequence parallelism: attention runs as ring attention
    over the axis (ops/ring_kernel.py).  `seq_group="auto"` lays the axis
    over the ranks of the default process group when `torch.distributed` is
    initialised and over shards on the current device otherwise; None forces
    the latter, a process group the former.  data=None takes the devices the
    other axes leave, which today is 1.
    """
    if pipe > 1:
        assert seq == 1, (
            "pipeline parallelism does not compose with sequence "
            "parallelism (as in neko_tpu/parallel/mesh.py)"
        )
        raise NotImplementedError("pipe > 1: pipeline parallelism is not yet ported")
    if model > 1:
        raise NotImplementedError("model > 1: tensor parallelism is not yet ported")
    if data is None:
        data = 1
    if data > 1:
        raise NotImplementedError("data > 1: data parallelism is not yet ported")
    assert data >= 1 and model >= 1 and seq >= 1, (data, seq, model)
    if seq_group == "auto":
        on_ranks = seq > 1 and dist.is_available() and dist.is_initialized()
        seq_group = dist.group.WORLD if on_ranks else None
    if seq_group is not None:
        n = dist.get_world_size(seq_group)
        assert data * seq * model == n, (
            f"mesh {data}x{seq}x{model} != {n} ranks of the process group"
        )
    return Mesh(("data", "seq", "model"), (data, seq, model), seq_group)


def seq_axis_size(mesh: Optional[Mesh]) -> int:
    """Size of the sequence-parallel axis of a mesh (1 when absent)."""
    if mesh is None:
        return 1
    return mesh.shape.get("seq", 1)
