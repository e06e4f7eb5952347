"""The port's host spans: named intervals at the layer boundaries of the
serving path and the training feed, kept in memory while a torch profiler
captures.

A span holds its name, `t0` and `t1` on `time.monotonic()` (the clock every
process of the machine shares, so a reader can place the spans on a
capture's timeline), the id of the thread it ran on
(`threading.get_native_id()`), its parent (the `sid` of the span that
enclosed it on the same thread) and a request id `rid` that all spans of
one request share.  Finished spans go into one bounded ring (the oldest
drop out); nothing here writes them anywhere: `spans(t0, t1)` hands them
to a reader.

The tracer is on only while a torch profiler captures (or inside
`enabled()`, for tests).  It asks through `capturing()`, which reads the
module global `torch.autograd.profiler._is_profiler_enabled`: torch sets it
for the whole process at a capture's start and end, so the engine's and the
HTTP handlers' threads see it too (`torch.autograd._profiler_enabled()`
reads True only on the thread that started the capture).  Off, a span is
one flag check and a shared no-op context: no clock read, no allocation.
On, each span is also a `torch.profiler.record_function` range of the same
name, which a capture shows for the threads it sees (the one that started
it and those started after).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

_ring: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_sids = itertools.count(1)
_local = threading.local()
_forced = 0


def capturing() -> bool:
    """Whether spans are recorded now: a torch profiler captures, seen from
    any thread, or a caller is inside `enabled()`."""
    return _forced > 0 or _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One interval; `rid` may be set while the span is open."""

    __slots__ = ("name", "rid", "t0", "t1", "tid", "sid", "parent", "_range")

    def __init__(self, name: str, rid=None, t0: float = 0.0, t1: float = 0.0):
        self.name, self.rid, self.t0, self.t1 = name, rid, t0, t1
        stack = _stack()
        self.parent: Optional[int] = stack[-1].sid if stack else None
        self.tid = threading.get_native_id()
        self.sid = next(_sids)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.monotonic()
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        _keep(self)
        return False


class _Off:
    """The span handed out while the tracer is off: enters, exits and takes
    a `rid` without doing anything."""

    __slots__ = ()
    rid = property(lambda self: None, lambda self, value: None)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _keep(s: Span) -> None:
    with _lock:
        _ring.append(s)


def span(name: str, rid=None):
    """A context manager timing its body as the span `name` (a child of the
    span open on this thread), or a no-op while the tracer is off."""
    if not capturing():
        return _OFF
    return Span(name, rid)


def record(name: str, t0: float, t1: float, rid=None) -> None:
    """Keep an interval measured elsewhere (`time.monotonic()` stamps) as the
    span `name`, a child of the span open on this thread; nothing while the
    tracer is off."""
    if capturing():
        _keep(Span(name, rid, t0, t1))


def spans(t0: float, t1: float) -> List[Span]:
    """The kept spans that start in [t0, t1), in the order they ended."""
    with _lock:
        return [s for s in _ring if t0 <= s.t0 < t1]


@contextlib.contextmanager
def enabled() -> Iterator[None]:
    """Record spans inside this block whether or not a profiler captures."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1
