"""The program's own spans (`neko_tpu_torch.utils.trace`) of a traced run,
placed on its capture's timeline, and the device-idle time inside them.

A span is kept by the program only while a torch profiler captures, on
`time.monotonic()`, the clock `trace.Reading.to_us` maps onto the capture.
A checkout whose program has no tracer gives no spans: the readers then
read nothing."""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.trace import union


def captured(run, *names: str) -> Optional[List[Tuple[object, float, float]]]:
    """(span, start us, end us) of the program's spans named `names` that
    started inside the run's capture; None without a capture or a tracer."""
    cap = run.capture
    if cap is None:
        return None
    try:
        from neko_tpu_torch.utils import trace
    except ImportError:
        return None
    return [(s, cap.to_us(s.t0), cap.to_us(s.t1)) for s in trace.spans(cap.host0, cap.host1)
            if s.name in names]


def idle_inside_s(run, *names: str) -> Optional[float]:
    """Seconds of the capture's device-idle gaps that fall inside the union
    of the spans `names`; None where no such span was kept."""
    found = captured(run, *names)
    if not found:
        return None
    inside = union([(a, b) for _, a, b in found])
    total = 0.0
    for g0, g1 in run.capture.gaps:
        for a, b in inside:
            if b > g0 and a < g1:
                total += min(b, g1) - max(a, g0)
    return total / 1e6
