"""The device mesh of the port (counterpart of neko_tpu/parallel/mesh.py).

The JAX package names its parallelism by mesh axes: batch on 'data', heads
and MLP width on 'model', the sequence on 'seq' (ring attention), pipeline
stages on 'pipe'.  The port keeps the names and neko_tpu's two grids:
('data', 'seq', 'model'), and ('data', 'pipe', 'model') when 'pipe' > 1
('pipe' and 'seq' do not compose, as in neko_tpu).

Over a process group.  When `torch.distributed` is initialised with more
than one rank, `create_mesh(data, model, seq, pipe)` lays the grid over the
ranks, one process per device, in neko_tpu's axis order: rank = (d * mid +
c) * model + m, where the middle axis is 'seq' or 'pipe' and c the rank's
coordinate on it, so a rank's coordinates are neko_tpu's `axis_index`
values.  The mesh carries one process group per axis of more than one rank
(the ranks that differ from this one only on that axis) and this rank's
coordinates (`Mesh.axis(name)`, a `collectives.Axis`; `LOCAL` for an axis
the grid does not have).  `TrainContext` shards the batch over 'data' (and,
with fsdp, the large leaves too), heads, MLP width and vocabulary over
'model' (parallel/sharding.py), the sequence over 'seq' (each rank holds
S / seq columns of every activation; attention runs as ring attention over
the 'seq' group, `seq_group`), and the layers over 'pipe'
(parallel/pipeline.py).

On one device.  `create_mesh(data=1, seq=n)` without a process group (or
`device_mesh(n)` inside one) gives a mesh whose sequence axis has n shards,
and inside `with mesh:` the train-mode attention runs as ring attention over
them (ops/attention.py reads `active_mesh()`).  The n shards are the n
consecutive S / n-row blocks of tensors that live whole on the current
device; the ring schedule walks them in place (views, no copies).  Every
other part of the step is unchanged there.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch.distributed as dist

from neko_tpu_torch.parallel.collectives import LOCAL, Axis

_active = threading.local()
AXES = ("data", "seq", "model")
PIPE_AXES = ("data", "pipe", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, the process group of the 'seq' axis (None: its
    shards live on the current device), and over a process group this
    rank's `Axis` of each named axis.  `with mesh:` makes it the active
    mesh of the thread."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    seq_group: Any = None
    axes: Tuple[Axis, ...] = (LOCAL, LOCAL, LOCAL)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def axis(self, name: str) -> Axis:
        """This rank's view of the axis `name` (`LOCAL` when it has size 1
        or the grid has no such axis)."""
        if name not in self.axis_names:
            return LOCAL
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


def _grid_axes(sizes: Tuple[int, int, int]) -> Tuple[Axis, ...]:
    """This rank's Axis on each axis of a (data, mid, model) grid over the
    default group.  Every rank creates every group, in the same order, as
    `dist.new_group` requires."""
    data, mid, model = sizes
    n_all = data * mid * model
    rank = dist.get_rank()
    coords = (rank // (mid * model), rank // model % mid, rank % model)
    axes = []
    for i, n in enumerate(sizes):
        if n == 1:
            axes.append(LOCAL)
            continue
        stride = (mid * model, model, 1)[i]
        mine = None
        # the ranks that differ from one rank only on axis i, for every such set
        for base in range(n_all):
            if (base // stride) % n:
                continue
            ranks = [base + j * stride for j in range(n)]
            group = dist.new_group(ranks) if n < n_all else dist.group.WORLD
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
    """Build a ('data', 'seq', 'model') mesh, or a ('data', 'pipe', 'model')
    one when `pipe` > 1.

    Over an initialised process group of more than one rank the grid spans
    its ranks (data=None takes what the other axes leave); without one,
    every axis but 'seq' must be 1 and `seq` > 1 puts ring attention's
    shards on the current device.
    """
    if pipe > 1 and seq > 1:  # neko_tpu's assertion, under `python -O` too
        raise AssertionError("pipeline parallelism does not compose with sequence "
                             "parallelism (as in neko_tpu/parallel/mesh.py)")
    n = world()
    mid, names = (pipe, PIPE_AXES) if pipe > 1 else (seq, AXES)
    if n > 1:
        if data is None:
            if n % (mid * model):
                raise ValueError(f"{n} ranks do not divide by {names[1]}={mid} x model={model}")
            data = n // (mid * model)
        if data * mid * model != n:
            raise ValueError(f"mesh {data}x{mid}x{model} != {n} ranks of the process group")
        axes = _grid_axes((data, mid, model))
        return Mesh(names, (data, mid, model), axes[1].group if seq > 1 else None, axes)
    data = 1 if data is None else data
    if data > 1 or model > 1 or pipe > 1:
        raise ValueError(
            f"create_mesh(data={data}, model={model}, pipe={pipe}) needs an initialised "
            f"torch.distributed group of {data * model * pipe} ranks (the train CLI's "
            "--multihost, under torchrun)")
    return device_mesh(seq)


def device_mesh(seq: int = 1) -> Mesh:
    """The one-device ('data', 'seq', 'model') mesh: `seq` sequence shards
    on the current device, whatever process group is initialised."""
    assert seq >= 1, seq
    return Mesh(AXES, (1, seq, 1), None)


def seq_axis_size(mesh: Optional[Mesh]) -> int:
    """Size of the sequence-parallel axis of a mesh (1 when absent), its
    shards on the device or over ranks."""
    if mesh is None:
        return 1
    return mesh.shape.get("seq", 1)


def seq_ranks(mesh: Optional[Mesh]) -> int:
    """Ranks the 'seq' axis spans (1 when its shards live on one device):
    each rank's activations hold S / seq_ranks columns."""
    return axis(mesh, "seq").size


def axis(mesh: Optional[Mesh], name: str) -> Axis:
    """`mesh.axis(name)`, `LOCAL` without a mesh."""
    return LOCAL if mesh is None else mesh.axis(name)
