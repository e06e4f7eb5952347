"""serve_admit_ms: mean wall ms of the window's `engine_admit` calls (one
prefill for every waiting request; a benchmark wrapper on the Generator,
which in a traced run waits for the device at the call's end)."""

import statistics


def read(run):
    r = run.readings
    calls = r.get("admit_s") if r.get("serve") else None
    return 1e3 * statistics.fmean(calls) if calls else None
