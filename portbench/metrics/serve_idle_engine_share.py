"""serve_idle_engine_share: the device-idle time of the capture that falls
while the engine thread does host-only work (the program's
`engine.bookkeep` and `admit.pack` spans), over the capture's wall time,
in percent."""

from portbench.program_spans import idle_inside_s


def read(run):
    if not run.readings.get("serve"):
        return None
    s = idle_inside_s(run, "engine.bookkeep", "admit.pack")
    return None if s is None else 100.0 * s / run.capture.window_s
