"""serve_p95_latency_s: the 95th percentile (nearest rank) over every
request sent in the window of the seconds from its send to its full reply,
those answered after the window's close included; a failed request counts
as missing (infinite), and a percentile that lands on one reads nothing."""

import math


def read(run):
    r = run.readings
    lat = sorted(r.get("latencies") or [])
    if not r.get("serve") or not lat:
        return None
    v = lat[math.ceil(0.95 * len(lat)) - 1]
    return v if math.isfinite(v) else None
