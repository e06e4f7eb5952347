"""train_optimizer_ms: device ms a captured step spends in the kernels that
start inside the step's "optimizer" range or AdamW's "Optimizer.step#"
range (clip + AdamW)."""


def _optimizer(name):
    return name == "optimizer" or name.startswith("Optimizer.step#")


def read(run):
    cap = run.capture
    if cap is None or not run.readings.get("capture_steps"):
        return None
    s = cap.in_ranges_s(_optimizer)
    return s * 1e3 / run.readings["capture_steps"] if s > 0 else None
