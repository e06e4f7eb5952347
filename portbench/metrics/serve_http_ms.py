"""serve_http_ms: the mean self time of the program's complete
`http.request` spans that started in the capture (`Handler.do_POST`, body
read to response written), less their `http.wait` children (the handler
blocked on the engine), in ms.  Complete: its wait was kept too (a request
that arrived as the capture stopped is traced without its wait)."""

import statistics

from portbench.program_spans import captured


def read(run):
    if not run.readings.get("serve"):
        return None
    found = captured(run, "http.request", "http.wait")
    if not found:
        return None
    waits = {}
    for s, _, _ in found:
        if s.name == "http.wait":
            waits[s.parent] = waits.get(s.parent, 0.0) + s.seconds
    selfs = [s.seconds - waits[s.sid] for s, _, _ in found
             if s.name == "http.request" and s.sid in waits]
    return 1e3 * statistics.fmean(selfs) if selfs else None
