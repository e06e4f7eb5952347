"""The device mesh of the port (counterpart of neko_tpu/parallel/mesh.py).

The JAX package names its parallelism by mesh axes: batch on 'data', heads
and MLP width on 'model', the sequence on 'seq' (ring attention), pipeline
stages on 'pipe'.  The port keeps the names and the ('data', 'seq', 'model')
order.

Over a process group.  When `torch.distributed` is initialised with more
than one rank, `create_mesh(data, model)` lays the grid over the ranks, one
process per device, in neko_tpu's axis order: rank = (d * seq + s) * model
+ m, so a rank's coordinates are neko_tpu's `axis_index` values.  The mesh
then carries one process group per axis of more than one rank (the ranks
that differ from this one only on that axis) and this rank's coordinates
(`Mesh.axis(name)`, a `collectives.Axis`).  `TrainContext` shards the batch
over 'data' (and, with fsdp, the large leaves too) and heads, MLP width and
vocabulary over 'model' (parallel/sharding.py).

On one device.  `create_mesh(data=1, seq=n)` gives a mesh whose sequence
axis has n shards, and inside `with mesh:` the train-mode attention runs as
ring attention over them (ops/attention.py reads `active_mesh()`).  The n
shards are the n consecutive S / n-row blocks of tensors that live whole on
the current device; the ring schedule walks them in place (views, no
copies).  A `Mesh` whose `seq_group` is a process group lays the shards over
its ranks instead (rank r holds shard r, kv blocks travel to rank + 1 by
point-to-point calls): the ring itself runs there
(`ring_kernel.ring_attention_bsd(group=)`), the train step does not yet.

Not ported yet (NotImplementedError, naming themselves): 'pipe' > 1, and
'seq' > 1 over a process group of more than one rank (sequence parallelism
over ranks: every non-attention part of the model would work on S / n
columns).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from neko_tpu_torch.parallel.collectives import LOCAL, Axis

_active = threading.local()
AXES = ("data", "seq", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, the process group of the one-device 'seq'
    axis (None: the shards live on the current device), and over a process
    group this rank's `Axis` of 'data' and 'model'.  `with mesh:` makes it
    the active mesh of the thread."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    seq_group: Any = None
    axes: Tuple[Axis, ...] = (LOCAL, LOCAL, LOCAL)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis(self, name: str) -> Axis:
        """This rank's view of the axis `name` (`LOCAL` when it has size 1)."""
        return self.axes[self.axis_names.index(name)]

    @property
    def on_ranks(self) -> bool:
        """True when the grid spans more than one process."""
        return any(a.on for a in self.axes)

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


def world() -> int:
    """Ranks of the initialised default process group (1 when none)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _grid_axes(data: int, seq: int, model: int) -> Tuple[Axis, ...]:
    """This rank's Axis on 'data', 'seq' and 'model' of a grid over the
    default group.  Every rank creates every group, in the same order, as
    `dist.new_group` requires."""
    sizes = (data, seq, model)
    rank = dist.get_rank()
    coords = (rank // (seq * model), rank // model % seq, rank % model)
    axes = []
    for i, n in enumerate(sizes):
        if n == 1:
            axes.append(LOCAL)
            continue
        stride = (seq * model, model, 1)[i]
        mine = None
        # the ranks that differ from one rank only on axis i, for every such set
        for base in range(data * seq * model):
            if (base // stride) % n:
                continue
            ranks = [base + j * stride for j in range(n)]
            group = dist.new_group(ranks) if n < data * seq * model else dist.group.WORLD
            if rank in ranks:
                mine = Axis(n, coords[i], group)
        axes.append(mine)
    return tuple(axes)


def create_mesh(
    data: Optional[int] = None,
    model: int = 1,
    seq: int = 1,
    pipe: int = 1,
) -> Mesh:
    """Build a ('data', 'seq', 'model') mesh.

    Over an initialised process group of more than one rank the grid spans
    its ranks (data=None takes what `model` leaves); without one, every axis
    but 'seq' must be 1 and `seq` > 1 puts ring attention's shards on the
    current device.
    """
    if pipe > 1:
        assert seq == 1, (
            "pipeline parallelism does not compose with sequence "
            "parallelism (as in neko_tpu/parallel/mesh.py)"
        )
        raise NotImplementedError("pipe > 1: pipeline parallelism is not yet ported "
                                  "(neko_tpu/parallel/pipeline.py)")
    n = world()
    if n > 1:
        if seq > 1:
            raise NotImplementedError(
                f"seq={seq} over a process group of {n} ranks: sequence parallelism over "
                "ranks is not yet ported (the next slice of the port)")
        if data is None:
            if n % model:
                raise ValueError(f"{n} ranks do not divide by model={model}")
            data = n // model
        if data * seq * model != n:
            raise ValueError(f"mesh {data}x{seq}x{model} != {n} ranks of the process group")
        return Mesh(AXES, (data, seq, model), None, _grid_axes(data, seq, model))
    data = 1 if data is None else data
    if data > 1 or model > 1:
        raise ValueError(
            f"create_mesh(data={data}, model={model}) needs an initialised "
            f"torch.distributed group of {data * model} ranks (the train CLI's --multihost, "
            "under torchrun)")
    assert data >= 1 and model >= 1 and seq >= 1, (data, seq, model)
    return Mesh(AXES, (data, seq, model), None)


def seq_axis_size(mesh: Optional[Mesh]) -> int:
    """Size of the one-device sequence-parallel axis of a mesh (1 when
    absent)."""
    if mesh is None:
        return 1
    return mesh.shape.get("seq", 1)


def axis(mesh: Optional[Mesh], name: str) -> Axis:
    """`mesh.axis(name)`, `LOCAL` without a mesh."""
    return LOCAL if mesh is None else mesh.axis(name)
