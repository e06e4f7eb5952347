"""Host spans of the benchmark's own calls, and the reading of a
torch.profiler capture: device busy time, idle gaps labelled by the host
span they fell in, kernel time by name and inside named ranges.

Host spans are (name, start, end) on `time.monotonic()`, the clock every
process of the machine shares.  A capture starts with a marker range whose
host time is known, which places the spans on the profiler's timeline."""

from __future__ import annotations

import contextlib
import re
import threading
import time
from typing import Dict, List, Tuple

MARKER = "portbench.clock"


class Spans:
    """Named host intervals, appended from any thread."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            with self._lock:
                self.items.append((name, t0, t1))

    def between(self, name: str, t0: float, t1: float) -> List[Tuple[float, float]]:
        """(start, end) of the spans `name` that started in [t0, t1)."""
        with self._lock:
            return [(a, b) for n, a, b in self.items if n == name and t0 <= a < t1]


class Capture:
    """A torch.profiler capture of the device; `start()` / `stop()` from
    one thread, the device synchronized at both ends."""

    def __init__(self):
        self.prof = None
        self.host0 = self.host1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.host0 = time.monotonic()
        with torch.profiler.record_function(MARKER):
            pass

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.host1 = time.monotonic()
        self.prof.__exit__(None, None, None)

    def reading(self, spans: Spans) -> "Reading":
        return Reading(self.prof.events(), self.host0, self.host1, spans)


def short_name(kernel: str) -> str:
    """A kernel's name without its template noise: torch's elementwise
    kernels by the functor they run, others cut to 100 characters."""
    if "elementwise_kernel" in kernel:
        ops = re.findall(r"\b(\w*(?:Functor\w*|_kernel_cuda|_kernel_impl\w*))", kernel)
        names = re.findall(r"at::native::(?:\(anonymous namespace\)::)?([A-Za-z_]\w*)", kernel)
        if ops:
            return f"elementwise {ops[-1]}"
        if len(names) > 1:
            return f"elementwise {names[1]}"
    return kernel.removeprefix("void ")[:100]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Reading:
    """What a capture shows, in seconds."""

    def __init__(self, events, host0: float, host1: float, spans: Spans):
        from torch.autograd import DeviceType

        marker = [e for e in events if e.name == MARKER and e.device_type == DeviceType.CPU]
        if not marker:
            raise RuntimeError("the capture has no clock marker")
        self.u0 = marker[0].time_range.start          # us on the profiler's timeline
        self.host0, self.host1 = host0, host1
        self.window_s = host1 - host0
        self.kernels = [(e.name, e.time_range.start, e.time_range.end) for e in events
                        if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
        self.ranges = [(e.name, e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.is_user_annotation]
        self.spans = [(n, self.to_us(a), self.to_us(b)) for n, a, b in spans.items
                      if b >= host0 and a <= host1]
        end = self.to_us(host1)
        busy = union([(max(a, self.u0), min(b, end)) for _, a, b in self.kernels
                       if b > self.u0 and a < end])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self.gaps = []
        t = self.u0
        for a, b in busy + [(end, end)]:
            if a > t:
                self.gaps.append((t, a))
            t = max(t, b)

    def to_us(self, host_t: float) -> float:
        return self.u0 + (host_t - self.host0) * 1e6

    def kernel_s(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any of `needles`."""
        return sum(b - a for n, a, b in self.kernels if any(s in n for s in needles)) / 1e6

    def count(self, needle: str) -> int:
        return sum(1 for n, _, _ in self.kernels if needle in n)

    def in_ranges_s(self, pred) -> float:
        """Device seconds of the kernels that start inside a device-side
        range whose name satisfies `pred`."""
        spans = [(a, b) for n, a, b in self.ranges if pred(n)]
        return sum(b - a for n, a, b in self.kernels
                   if any(x <= a < y for x, y in spans)) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def label(self, t: float) -> str:
        inside = [(b - a, n) for n, a, b in self.spans if a <= t < b]
        return min(inside)[1] if inside else "outside portbench spans"

    def breakdown(self, top: int = 10) -> Dict:
        by_name: Dict[str, float] = {}
        for n, a, b in self.kernels:
            k = short_name(n)
            by_name[k] = by_name.get(k, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.label(a), (b - a) / 1e6] for a, b in gaps]}
