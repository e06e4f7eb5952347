"""train_host_wait_ms: mean ms a window step waits in HostPrefetcher.get()
for its packed batch (a benchmark span around the call)."""

import statistics


def read(run):
    waits = run.readings.get("host_wait_s")
    return statistics.fmean(waits) * 1e3 if waits else None
