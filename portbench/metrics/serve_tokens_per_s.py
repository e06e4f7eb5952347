"""serve_tokens_per_s: tokens of the replies completed in the window, over
the window."""


def read(run):
    r = run.readings
    return r["tokens_done"] / r["window_s"] if r.get("serve") else None
