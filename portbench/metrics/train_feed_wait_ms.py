"""train_feed_wait_ms: the median ms of the captured steps' `pipeline.wait`
spans (`HostPrefetcher.get`, one a step: the queue get and the wait on the
batch's copy event).  The median, as one of the few captured steps may
stall on the capture itself: the first wait starts as the capture does."""

import statistics

from portbench.program_spans import captured


def read(run):
    waits = captured(run, "pipeline.wait") if run.readings.get("capture_steps") else None
    return 1e3 * statistics.median(s.seconds for s, _, _ in waits) if waits else None
