"""train_idle_share: the share of the capture's wall time in which no
kernel or copy ran on the device, in percent."""


def read(run):
    cap = run.capture
    if cap is None or "tokens_per_step" not in run.readings:
        return None
    return 100.0 * cap.idle_share()
