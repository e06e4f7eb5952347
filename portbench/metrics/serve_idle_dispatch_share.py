"""serve_idle_dispatch_share: the device-idle time of the capture that
falls while the engine enqueues device work (the program's `decode.step`
and `admit.prefill` spans), over the capture's wall time, in percent."""

from portbench.program_spans import idle_inside_s


def read(run):
    if not run.readings.get("serve"):
        return None
    s = idle_inside_s(run, "decode.step", "admit.prefill")
    return None if s is None else 100.0 * s / run.capture.window_s
