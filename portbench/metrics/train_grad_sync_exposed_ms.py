"""train_grad_sync_exposed_ms: device ms a captured step on rank 0 in which
NCCL kernels run and no other kernel does (the gradient all-reduce not
hidden behind compute)."""

from portbench.trace import union


def read(run):
    cap, r = run.capture, run.readings
    if cap is None or r.get("ranks", 1) < 2 or not r.get("capture_steps"):
        return None
    nccl = union([(a, b) for n, a, b in cap.kernels if "nccl" in n.lower()])
    busy = union([(a, b) for n, a, b in cap.kernels if "nccl" not in n.lower()])
    if not nccl:
        return None
    exposed = 0.0
    for a, b in nccl:
        covered = 0.0
        for x, y in busy:
            covered += max(0.0, min(b, y) - max(a, x))
        exposed += (b - a) - covered
    return exposed / 1e3 / r["capture_steps"]
