"""serve_decode_step_ms: wall ms of the window's `engine_chunk` calls (a
benchmark wrapper on the Generator; the call ends by copying its tokens to
the host) over their decode steps."""


def read(run):
    r = run.readings
    calls = r.get("chunk_steps") if r.get("serve") else None
    if not calls:
        return None
    return 1e3 * sum(s for s, _ in calls) / sum(n for _, n in calls)
