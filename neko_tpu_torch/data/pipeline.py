"""Host-side prefetch pipeline (counterpart of neko_tpu/data/pipeline.py).

Background threads keep a small queue of batches ahead of the train step:
while the device runs step N, a thread samples and packs step N+1 and
starts its copy to the device.

On a CUDA device the copy must not serialize with the step.  The
prefetcher owns a side stream: `sample_fn` runs under it (the Trainer's
`_produce_batch` copies the packed arrays from pinned host memory with
non-blocking copies, data/batch.py), and an event is recorded on the side
stream after it.  `get()` makes the consumer's current stream wait on that
event before the batch is used, and marks each of the item's tensors as
used on the consumer's stream (`record_stream`), so the caching allocator
does not hand their memory out again while the step still reads them.

With `workers > 1`, several threads produce batches concurrently; the batch
order then depends on thread scheduling, so exact resume needs the default
of 1 (the Trainer refuses to checkpoint otherwise).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import torch

from neko_tpu_torch.utils import trace


def _tensors(item):
    """Every tensor in a (nested) tuple / list / dict / dataclass."""
    if isinstance(item, torch.Tensor):
        yield item
    elif isinstance(item, (tuple, list)):
        for x in item:
            yield from _tensors(x)
    elif isinstance(item, dict):
        for x in item.values():
            yield from _tensors(x)
    elif dataclasses.is_dataclass(item) and not isinstance(item, type):
        for f in dataclasses.fields(item):
            yield from _tensors(getattr(item, f.name))


class HostPrefetcher:
    """Runs `sample_fn` in daemon thread(s), keeping up to `depth` results.
    `device`: a CUDA device gets the side stream described above."""

    def __init__(
        self,
        sample_fn: Callable[[], object],
        depth: int = 2,
        workers: int = 1,
        device=None,
    ):
        self._sample_fn = sample_fn
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        dev = None if device is None else torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device=dev) if dev is not None and dev.type == "cuda" else None)
        # most recent wall-clock seconds one produce call took (sample +
        # pack + the copy launched); read by the Trainer's logs
        self.last_produce_time = 0.0
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def _produce(self):
        if self._stream is None:
            return self._sample_fn(), None
        with torch.cuda.stream(self._stream):
            item = self._sample_fn()
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return item, ready

    def _worker(self):
        while not self._stop.is_set():
            try:
                t0 = time.perf_counter()
                item = ("ok", self._produce())
                self.last_produce_time = time.perf_counter() - t0
            except BaseException as e:  # forwarded to the consumer
                item = ("err", e)
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "err":
                return

    def get(self):
        with trace.span("pipeline.wait"):
            kind, value = self._queue.get()
            if kind == "err":
                raise value
            item, ready = value
            if ready is not None:
                consumer = torch.cuda.current_stream(self._stream.device)
                consumer.wait_event(ready)
                for t in _tensors(item):
                    if t.is_cuda:
                        t.record_stream(consumer)
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=10.0)
