"""serve_decode_dispatch_ms: the median host ms of the program's
`decode.step` spans in the capture: picking a token and enqueuing one
decode step of every slot (`Generator.engine_chunk`), the device not
waited for.  The median, as a few steps stall behind the handler threads
and the capture's own work; a traced reading, to be compared only with
other traced readings (the profiler slows each launch)."""

import statistics

from portbench.program_spans import captured


def read(run):
    if not run.readings.get("serve"):
        return None
    steps = captured(run, "decode.step")
    return 1e3 * statistics.median(s.seconds for s, _, _ in steps) if steps else None
