"""train_tokens_per_s: rows x context of every train step of the window,
over the window (from its start to the device's end of its last step),
summed over ranks."""


def read(run):
    r = run.readings
    if "tokens_per_step" not in r:
        return None
    return r["steps"] * r["tokens_per_step"] * r.get("ranks", 1) / r["window_s"]
