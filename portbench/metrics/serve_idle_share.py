"""serve_idle_share: the share of the capture's wall time in which no
kernel or copy ran on the device, in percent."""


def read(run):
    cap = run.capture
    if cap is None or not run.readings.get("serve"):
        return None
    return 100.0 * cap.idle_share()
