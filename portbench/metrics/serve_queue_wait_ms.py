"""serve_queue_wait_ms: the continuous engine's counters (`stats`, read
from the server's GET /metrics) as differences over the window: the
seconds its admitted requests waited from `NekoServer.submit` to leaving
the engine's queue, over the requests admitted, in ms."""


def read(run):
    r = run.readings
    if not r.get("serve"):
        return None
    s0, s1 = r["stats"]
    if "queue_wait_s" not in s1:
        return None
    admitted = s1["admitted"] - s0["admitted"]
    if admitted <= 0:
        return None
    return 1e3 * (s1["queue_wait_s"] - s0["queue_wait_s"]) / admitted
