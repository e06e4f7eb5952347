"""serve_slot_occupancy: the continuous engine's counters (`stats`, read
from the server's GET /metrics) as differences over the window: tokens delivered over the tokens its chunks
could have given (chunks x chunk x slots), in percent."""


def read(run):
    r = run.readings
    if not r.get("serve"):
        return None
    s0, s1 = r["stats"]
    chunks = s1["chunks"] - s0["chunks"]
    if chunks <= 0:
        return None
    return 100.0 * (s1["tokens_out"] - s0["tokens_out"]) / (chunks * r["chunk"] * r["slots"])
